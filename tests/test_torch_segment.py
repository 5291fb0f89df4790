"""Port parity for ops.segment, the fixed-order segment sum that stands
in for every atomic scatter of the port (jax.ops.segment_sum's
counterpart).

The same seeded numpy inputs go through `jax.ops.segment_sum`,
`np.add.at` and `segment.SegmentSum`.  Gates: per segment, 1e-15 of the
segment's sum of |x| in f64 and 1e-6 of it in f32 (the sums add in
another order: chunks of segment.CHUNK, then the chunk sums); empty
segments exactly zero; two calls bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padne_tpu_torch.ops import segment

R = 3
TOL = {np.float64: 1e-15, np.float32: 1e-6}


def seeded_segments(n, p, seed, skew=False):
    """n segment ids in [0, p): uniform, or with one segment holding 90%
    of the rows; the last two segments always empty when p > 3."""
    rng = np.random.default_rng(seed)
    top = p - 2 if p > 3 else p
    seg = rng.integers(0, top, n)
    if skew:
        seg[rng.random(n) < 0.9] = top // 2
    return seg


def check_sums(seg, p, x, dim, dtype):
    """SegmentSum of x (axis `dim` over the entries) against
    jax.ops.segment_sum and np.add.at."""
    x = x.astype(dtype)
    rows = np.moveaxis(x, dim, 0)
    want = np.zeros((p,) + rows.shape[1:], np.float64)
    np.add.at(want, seg, rows.astype(np.float64))
    jwant = np.asarray(jax.ops.segment_sum(
        jnp.asarray(rows), jnp.asarray(seg), num_segments=p))
    scale = np.zeros_like(want)
    np.add.at(scale, seg, np.abs(rows.astype(np.float64)))
    got = segment.SegmentSum(seg, p)(torch.from_numpy(x), dim)
    assert got.dtype == torch.from_numpy(x).dtype
    got = np.moveaxis(got.numpy(), dim, 0)
    assert got.shape == want.shape
    bound = TOL[dtype] * scale
    assert (np.abs(got - want) <= bound).all()
    assert (np.abs(got - jwant) <= bound).all()
    empty = scale == 0
    assert (got[empty] == 0).all()


@pytest.mark.parametrize("p", [1, 5, 70, 300])
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_segment_sum_matches_jax_and_numpy(p, skew, dtype):
    n = 4000
    seg = seeded_segments(n, p, seed=p, skew=skew)
    rng = np.random.default_rng(p + 1)
    check_sums(seg, p, rng.standard_normal(n), 0, dtype)
    check_sums(seg, p, rng.standard_normal((n, R)), 0, dtype)
    check_sums(seg, p, rng.standard_normal((R, n)), 1, dtype)


@pytest.mark.parametrize("n", [0, 1, segment.CHUNK - 1, segment.CHUNK,
                               segment.CHUNK + 1, segment.CHUNK ** 2 + 1])
def test_chunk_boundaries(n):
    """One segment of n rows beside an empty one: the sizes where a
    chunk or a stage fills up exactly or spills by one."""
    seg = np.zeros(n, np.int64)
    s = segment.SegmentSum(seg, 2)
    assert len(s.stages) == (0 if n <= 1 else
                             int(np.ceil(np.log(n) / np.log(segment.CHUNK)
                                         - 1e-12)))
    x = np.random.default_rng(n).standard_normal((R, n))
    check_sums(seg, 2, x, 1, np.float64)


def test_padding_stays_bounded():
    """One component of 90% of a million rows beside 144 small ones (the
    fragmented board's shape): every stage pads at most CHUNK - 1 slots
    per non-empty segment, nothing like p x the largest segment."""
    n, p = 1_000_000, 145
    seg = seeded_segments(n, p, seed=3, skew=True)
    s = segment.SegmentSum(seg, p)
    items = n
    for idx, pad in s.stages:
        assert len(idx) == len(pad) <= items + p * (segment.CHUNK - 1)
        assert int((~pad).sum()) == items   # every item read once
        items = len(idx) // segment.CHUNK
    assert len(s.stages) == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_two_calls_are_bit_equal(dtype):
    seg = seeded_segments(20000, 70, seed=7, skew=True)
    s = segment.SegmentSum(seg, 70)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (R, 20000))).to(dtype)
    a, b = s(x, 1), s(x.clone(), 1)
    assert torch.equal(a, b)
    # A second layout of the same index sums in the same order.
    assert torch.equal(segment.SegmentSum(seg, 70)(x, 1), a)


def test_bad_input_raises():
    with pytest.raises(ValueError, match="outside"):
        segment.SegmentSum(np.array([0, 3]), 3)
    with pytest.raises(ValueError, match="outside"):
        segment.SegmentSum(np.array([-1, 0]), 3)
    s = segment.SegmentSum(np.array([0, 1, 1]), 2)
    with pytest.raises(ValueError, match="entries"):
        s(torch.zeros(4))
