"""vss_tpu_torch/entry.py on the CPU: `entry()` against the JAX package's
`__graft_entry__.entry()` (the same host-built graph and queries, so the
same ids; distances within rtol 1e-5, atol 1e-4), and
`dryrun_multichip` over CPU slots."""
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from vss_tpu_torch.entry import dryrun_multichip, entry


def test_entry_equals_jax():
    jfn, jargs = jentry.entry()
    tfn, targs = entry(device="cpu")
    np.testing.assert_array_equal(targs[1].numpy(), np.asarray(jargs[1]))
    for f in ("adj0", "upper_adj", "levels", "upper_row", "valid", "slot_to_rowid"):
        np.testing.assert_array_equal(getattr(targs[0], f).numpy(),
                                      np.asarray(getattr(jargs[0], f)), err_msg=f)
    jd, ji = jfn(*jargs)
    td, ti = tfn(*targs)
    assert tuple(ti.shape) == (64, 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)


def test_entry_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry() runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


@pytest.mark.parametrize("n_devices", [1, 4])
def test_dryrun_multichip_on_cpu_slots(n_devices):
    dryrun_multichip(n_devices, device="cpu")
