"""The Triton LK kernel (interpret mode on CPU) and the FAST stencil vs
their plain oracles, and the platform rule that picks the LK path.

``lk_triton.track_batch`` must reproduce ``lk.track`` (the plain-JAX
levels) up to summation order: the same flows wherever both mark a
feature ok, and the same ok flags.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi

from x_multi_agent_jax.vision import fast, lk, lk_triton
from x_multi_agent_jax.vision.image import build_pyramid


def _smooth(rng, h, w, sigma=2.0):
    return ndi.gaussian_filter(
        rng.normal(size=(h, w)) * 50 + 128, sigma
    ).astype(np.float64)


def _pair(rng, h, w, shift=(0.7, -1.3), n_agents=1):
    """(pyr_prev, pyr_cur) batched over agents; content moves by ``shift``
    = (dy, dx) between the frames."""
    prev = np.stack([_smooth(rng, h, w) for _ in range(n_agents)])
    cur = np.stack([ndi.shift(p, shift, order=3) for p in prev])
    pyr = jax.vmap(lambda im: build_pyramid(im, 2))
    return pyr(jnp.asarray(prev)), pyr(jnp.asarray(cur))


def _oracle(pyr_prev, pyr_cur, pts, valid, **kw):
    return jax.vmap(lambda pp, pc, p, v: lk.track(pp, pc, p, v, **kw))(
        list(pyr_prev), list(pyr_cur), pts, valid
    )


def _assert_same(got, want, atol=1e-6):
    (pg, okg), (pw, okw) = got, want
    okg, okw = np.asarray(okg), np.asarray(okw)
    np.testing.assert_array_equal(okg, okw)
    assert okw.any(), "no feature tracked: the comparison is vacuous"
    np.testing.assert_allclose(np.asarray(pg)[okw], np.asarray(pw)[okw], atol=atol)


@pytest.mark.parametrize("half_win", [10, 4])
def test_lk_kernel_one_level_matches_oracle(rng, half_win):
    # 21x21 windows fill 441 of 512 lanes, 9x9 windows 81 of 128
    pp, pc = _pair(rng, 96, 160)
    pp, pc = pp[:1], pc[:1]
    pts = jnp.asarray(rng.uniform([20, 20], [140, 76], size=(1, 21, 2)))
    valid = jnp.ones((1, 21), bool)
    got = lk_triton.track_batch(
        pp, pc, pts, valid, half_win=half_win, interpret=True
    )
    _assert_same(got, _oracle(pp, pc, pts, valid, half_win=half_win))


def test_lk_kernel_odd_sizes_and_borders(rng):
    # odd level sizes (77x133 -> 39x67 -> 20x34) and windows that hang over
    # every border: the kernel's clamped gathers must equal the oracle's
    # edge padding, and invalid slots must stay not-ok
    pp, pc = _pair(rng, 77, 133, shift=(0.4, 0.9))
    pts = np.concatenate([
        rng.uniform([0, 0], [133, 77], size=(12, 2)),
        [[2.5, 3.5], [130.2, 74.8], [-1.0, 40.0], [66.0, 76.5]],
    ])[None]
    valid = np.ones((1, 16), bool)
    valid[0, 3] = False
    got = lk_triton.track_batch(
        pp, pc, jnp.asarray(pts), jnp.asarray(valid), half_win=7, interpret=True
    )
    want = _oracle(pp, pc, jnp.asarray(pts), jnp.asarray(valid), half_win=7)
    _assert_same(got, want)
    assert not bool(np.asarray(got[1])[0, 3])


def test_lk_kernel_full_pyramid_recovers_shift(rng):
    shift = (2.4, -3.1)  # (dy, dx)
    pp, pc = _pair(rng, 128, 192, shift=shift)
    k = 16
    pts = jnp.asarray(rng.uniform([30, 30], [162, 98], size=(1, k, 2)))
    pts_cur, ok = lk_triton.track_batch(
        pp, pc, pts, jnp.ones((1, k), bool), interpret=True
    )
    ok = np.asarray(ok)[0]
    assert ok.sum() >= k // 2
    flow = np.asarray(pts_cur - pts)[0][ok]
    # ndi.shift moves content BY (dy, dx): prev (x, y) appears at (x+dx, y+dy)
    true_flow = np.array([shift[1], shift[0]])
    np.testing.assert_allclose(np.median(flow, axis=0), true_flow, atol=0.1)
    assert (np.abs(flow - true_flow) < 0.2).all(axis=1).mean() > 0.8


def test_lk_kernel_agents_batched_vs_vmapped_oracle(rng):
    pp, pc = _pair(rng, 64, 96, shift=(-1.1, 0.6), n_agents=3)
    pts = jnp.asarray(rng.uniform([12, 12], [84, 52], size=(3, 10, 2)))
    valid = jnp.asarray(rng.random((3, 10)) > 0.2)
    got = lk_triton.track_batch(pp, pc, pts, valid, interpret=True)
    _assert_same(got, _oracle(pp, pc, pts, valid))


def test_lk_platform_rule(rng):
    assert lk.uses_kernel("gpu")
    assert not lk.uses_kernel("cpu")
    # on this CPU run the batched entry point is the vmapped plain path
    pp, pc = _pair(rng, 64, 96, n_agents=2)
    pts = jnp.asarray(rng.uniform([12, 12], [84, 52], size=(2, 6, 2)))
    valid = jnp.ones((2, 6), bool)
    got = lk.track_batch(pp, pc, pts, valid)
    want = _oracle(pp, pc, pts, valid)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


def test_fast_detect_batch_equals_vmapped_detect(rng):
    imgs = jnp.asarray(
        np.stack([_smooth(rng, 76, 132, sigma=1.0) for _ in range(3)])
    )
    got = fast.detect_batch(imgs, 3.0, 2, 4, 6)
    want = jax.vmap(lambda im: fast.detect(im, 3.0, 2, 4, 6))(imgs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(np.asarray(got[2]).sum()) > 0


def test_nms3_matches_maximum_filter(rng):
    score = rng.random((37, 53)) * (rng.random((37, 53)) > 0.5)
    got = np.asarray(fast.nms3(jnp.asarray(score)))
    peak = ndi.maximum_filter(score, size=3, mode="constant", cval=-np.inf)
    np.testing.assert_array_equal(got, np.where(score >= peak, score, 0.0))


@pytest.mark.gpu
def test_lk_kernel_compiled_matches_oracle(gpu, rng):
    """The kernel as the GPU compiles it (not interpreted), float32."""
    with jax.default_device(gpu):
        pp, pc = _pair(rng, 120, 160, n_agents=2)
        pp = [jnp.asarray(x, jnp.float32) for x in pp]
        pc = [jnp.asarray(x, jnp.float32) for x in pc]
        pts = jnp.asarray(rng.uniform([15, 15], [145, 105], size=(2, 40, 2)), jnp.float32)
        valid = jnp.ones((2, 40), bool)
        got = jax.jit(lk_triton.track_batch)(pp, pc, pts, valid)
        _assert_same(got, _oracle(pp, pc, pts, valid), atol=1e-3)
