"""The port's hex padding and exact rotations against hygrid_tpu.

Both are permutations or copies with a constant fill, so every result is
bit-equal to the reference's (dtype included): ``heximpad`` in every
padding mode and form, pads larger than the image included, and
``hexrot60`` / ``hexflip`` at every k, pivots and odd and even sizes, float
and integer.
"""
import numpy as np
import pytest
import torch

from hygrid_tpu.ops import hexrot as jrot
from hygrid_tpu.ops import pad as jpad
from hygrid_tpu_torch.kernels import resample
from hygrid_tpu_torch.utils.profiling import counts
from hygrid_tpu_torch.ops import hexrot as trot
from hygrid_tpu_torch.ops import pad as tpad
from hygrid_tpu_torch.ops import sampling
import hygrid_tpu_torch as pt

MODES = ["constant", "edge", "reflect", "symmetric"]
# one int, a 2-tuple, a 4-tuple with an odd top, pads larger than the image
PADDINGS = [(3, 0), ((2, 3), 7), ((0, 5, 9, 2), 0), ((7, 7, 7, 7), 7)]


def _image(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) - 0.25) * 200).astype(dtype)


def _same(got, want):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype,shape", [("float32", (5, 7)),
                                         ("uint8", (6, 4, 3)),
                                         ("int32", (1, 3))])
@pytest.mark.parametrize("mode", MODES)
def test_heximpad_matches_jax(mode, shape, dtype):
    img = _image(shape, dtype)
    for padding, pad_val in PADDINGS:
        want = jpad.heximpad(img, padding=padding, pad_val=pad_val,
                             padding_mode=mode)
        got = tpad.heximpad(img, padding=padding, pad_val=pad_val,
                            padding_mode=mode, device="cpu")
        _same(got, want)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_heximpad_shape_and_channel_values(dtype):
    img = _image((7, 5, 3), dtype, seed=1)
    _same(tpad.heximpad(img, shape=(12, 9), device="cpu"),
          jpad.heximpad(img, shape=(12, 9)))
    _same(tpad.heximpad(img, padding=(1, 3, 2, 0), pad_val=(5, 9, 200),
                        device="cpu"),
          jpad.heximpad(img, padding=(1, 3, 2, 0), pad_val=(5, 9, 200)))
    # a tensor is padded on its own device, in its own dtype
    got = tpad.heximpad(torch.from_numpy(img), padding=2)
    assert got.device.type == "cpu" and str(got.dtype)[6:] == dtype


def test_heximpad_moves_odd_top_row_and_guards():
    img = np.ones((4, 4), np.float32)
    out = tpad.heximpad(img, padding=(0, 3, 0, 0), device="cpu")
    # 3 rows asked on top: 2 go on top (parity kept), 1 to the bottom
    assert out.shape == (7, 4)
    assert out[:2].sum() == 0 and out[-1].sum() == 0 and out[2:6].sum() == 16
    with pytest.raises(ValueError):
        tpad.heximpad(img, padding=[1, 2], device="cpu")
    with pytest.raises(TypeError):
        tpad.heximpad(img, padding=1, pad_val="x", device="cpu")
    with pytest.raises(AssertionError):
        tpad.heximpad(img, padding=1, padding_mode="wrap", device="cpu")


@pytest.mark.parametrize("shape", [(13, 10), (9, 17, 3)])
@pytest.mark.parametrize("divisor", [4, 8])
def test_hex_impad_to_multiple_matches_jax(shape, divisor):
    img = _image(shape, "float32", seed=2)
    _same(tpad.hex_impad_to_multiple(img, divisor, pad_val=3, device="cpu"),
          jpad.hex_impad_to_multiple(img, divisor, pad_val=3))


@pytest.mark.parametrize("dtype,shape,pivot,ks", [
    ("float32", (2, 3, 9, 12), None, range(7)),
    ("uint8", (11, 7), (2, 3), (1, 3, 5)),
    ("int32", (3, 10, 10), (0, 0), (2, 4, 6)),
    ("float32", (11, 7), (9, 6), (1, 5))])
def test_hexrot60_matches_jax(shape, dtype, pivot, ks):
    img = _image(shape, dtype, seed=3)
    for k in ks:
        _same(trot.hexrot60(img, k, pivot, device="cpu"),
              jrot.hexrot60(img, k, pivot))


def test_hexrot60_plans_bit_equal_and_dense():
    """The plan is the reference's, bit for bit; rotations other than the
    identity have no row-band form, so plan_gather takes its dense
    tables, and none takes the shift resampler."""
    for k in range(6):
        plan = trot.rot_plan(33, 40, k)
        want = jrot._build_rot_plan(33, 40, k, None)
        assert plan.out_shape == want.out_shape and plan.exact_select
        assert np.array_equal(plan.idx, want.idx)
        assert np.array_equal(plan.weights, want.weights)
        for esz in (4, 2):
            assert not sampling.takes_shift_route(plan, esz)
            form = resample.gather_tables_cached(plan, esz).index_form
            assert (form == "dense") is (k != 0)


def test_hexrot60_keeps_every_value_and_cpu_counts_no_launch():
    img = torch.from_numpy(_image((2, 12, 14), "float32", seed=4))
    before = counts().get("plan_gather", 0)
    for k in range(1, 6):
        out = trot.hexrot60(img, k)
        mask = torch.from_numpy(trot.rot_plan(12, 14, k).weights[0] > 0)
        # each source cell lands on exactly one output cell
        assert int(mask.sum()) == 12 * 14
        assert torch.equal(torch.sort(out[:, mask].flatten())[0],
                           torch.sort(img.flatten())[0])
        assert not out[:, ~mask].any()
    assert counts().get("plan_gather", 0) == before


@pytest.mark.parametrize("axis,dtype", [("horizontal", "float32"),
                                        ("vertical", "uint8")])
def test_hexflip_matches_jax(axis, dtype):
    img = _image((2, 3, 7, 9), dtype, seed=5)
    _same(trot.hexflip(img, axis, device="cpu"), jrot.hexflip(img, axis))
    with pytest.raises(ValueError):
        trot.hexflip(img, "diagonal", device="cpu")


def test_top_level_exports():
    for name in ("heximpad", "hex_impad_to_multiple", "hexrot60", "hexflip",
                 "hexrot60_same", "random_hexrot60", "random_hexflip",
                 "random_hex_translate", "augment_hex_batch", "IMAGE",
                 "HEXIMAGE"):
        assert name in pt.__all__ and hasattr(pt, name), name
    from hygrid_tpu_torch import ops, viz
    from hygrid_tpu_torch.ops import tiled
    assert "heximpad" in ops.__all__ and "augment_hex_batch" in ops.__all__
    assert callable(tiled.tiled_resample)
    assert {"Texture", "Window"} <= set(viz.__all__)
