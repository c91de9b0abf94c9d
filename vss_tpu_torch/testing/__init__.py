"""Test runners. Reproduces `vss_tpu/testing/__init__.py`."""
from vss_tpu_torch.testing.sqllogic import SQLLogicRunner, run_sqllogic_file

__all__ = ["SQLLogicRunner", "run_sqllogic_file"]
