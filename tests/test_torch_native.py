"""The port's byte form of points (zprize_tpu_torch/utils/native.py)
against the reference's host library (`native/zk_host.cc`, built with g++
by the reference's `utils/native.py`, as tests/test_native.py does), on
both curves and at a coordinate width of 48 and of 64 bytes."""

import pytest

from zprize_tpu.curve.spec import BLS12_377_G1 as REF_377
from zprize_tpu.curve.spec import BLS12_381_G1 as REF_381
from zprize_tpu.utils import native as ref_native
from zprize_tpu_torch.curve.spec import BLS12_377_G1, BLS12_381_G1
from zprize_tpu_torch.utils import native, oracle
from torch_memory import release_memory  # noqa: F401

CURVES = {"377": (BLS12_377_G1, REF_377), "381": (BLS12_381_G1, REF_381)}


@pytest.mark.parametrize("nbytes", [48, 64])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_bytes_equal_the_reference_library(name, nbytes):
    curve, ref_curve = CURVES[name]
    pts = oracle.generator_chain(curve, 5) + [None]
    data = native.serialize_points(curve, pts, nbytes)
    assert data == ref_native.serialize_points(ref_curve, pts, nbytes)
    assert len(data) == len(pts) * 2 * nbytes
    ident = data[5 * 2 * nbytes:]
    assert ident == bytes(2 * nbytes - 1) + b"\x40"
    back = ref_native.deserialize_points(ref_curve, data, nbytes)
    assert back == pts
    assert native.deserialize_points(curve, data, nbytes) == back


def test_narrow_records_and_trailing_bytes_match_the_reference():
    """Below 48 bytes a coordinate is cut to its low bytes; a zero point is
    flagged like None; bytes after the last whole record are ignored."""
    curve, ref_curve = CURVES["377"]
    pts = oracle.generator_chain(curve, 2) + [(0, 0), None]
    for nbytes in (1, 32):
        data = native.serialize_points(curve, pts, nbytes)
        assert data == ref_native.serialize_points(ref_curve, pts, nbytes)
        tail = data + b"\x01\x02\x03"
        assert (native.deserialize_points(curve, tail, nbytes)
                == ref_native.deserialize_points(ref_curve, tail, nbytes))
    with pytest.raises(ValueError, match="at least one byte"):
        native.serialize_points(curve, pts, 0)
