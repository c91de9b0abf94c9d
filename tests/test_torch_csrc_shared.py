"""The device code that several kernels of `vss_tpu_torch/csrc/` share is
written once: each shared helper is defined in one file (its overloads
together), which every kernel that uses it includes, so that a change to
it, or a mutant of it in the emulated tests, reaches all of them. Read
from the sources; nothing is compiled."""
import os
import re

import pytest

from vss_tpu_torch import csrc

_DIR = os.path.dirname(os.path.abspath(csrc.__file__))

# helper -> the header that holds it
SHARED = {
    # K2's tile code, shared with pivot_product
    "q_offset": "tiles.cuh", "b_desc": "tiles.cuh", "pack2": "tiles.cuh",
    "decode4": "tiles.cuh", "decode_slab": "tiles.cuh", "await_products": "tiles.cuh",
    "with_steps": "tiles.cuh", "RingPos": "tiles.cuh",
    # the order of floats that every selection and sort keeps
    "order_key": "common.cuh", "key_float": "common.cuh",
    # the tape's chunks
    "load_chunk": "gather.cuh", "decode": "gather.cuh",
}
# the copies the shared helpers replaced
GONE = ("sort_key", "argmin_key", "key_value", "row_chunk", "chunk_values")


def _sources() -> dict[str, str]:
    """Each .cu and .cuh file of csrc/, its comments taken out."""
    texts = {}
    for name in sorted(os.listdir(_DIR)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(_DIR, name)) as f:
                text = f.read()
            text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
            texts[name] = re.sub(r"//[^\n]*", "", text)
    return texts


def _defines(text: str, name: str) -> bool:
    """A struct of that name, or a function: qualifiers and a return type
    on the line of the name, then its parameters and a body."""
    struct = re.search(rf"^\s*struct\s+{name}\s*\{{", text, flags=re.M)
    function = re.search(
        rf"^\s*(?:__\w+__\s+|inline\s+|static\s+|constexpr\s+)+[\w:<>,\s\*&]*?\b{name}\s*"
        rf"\([^;{{]*\)\s*(?:const\s*)?\{{", text, flags=re.M)
    return bool(struct or function)


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_device_helper_is_defined_in_one_file(name):
    files = [f for f, text in _sources().items() if _defines(text, name)]
    assert files == [SHARED[name]], (name, files)


@pytest.mark.parametrize("name", GONE)
def test_replaced_copies_are_gone(name):
    hits = [f for f, text in _sources().items() if re.search(rf"\b{name}\b", text)]
    assert hits == [], (name, hits)


def test_every_included_header_is_listed():
    """Every header of csrc/ that a source includes is in `csrc._HEADERS`,
    so that a change to it rebuilds the libraries (`_stale`) and the
    emulated tests copy it."""
    for name, text in _sources().items():
        for header in re.findall(r'#include "([^"]+)"', text):
            assert header in csrc._HEADERS, (name, header)
