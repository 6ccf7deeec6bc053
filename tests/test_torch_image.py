"""Port parity: image primitives and the pyramid (dis_tpu_torch vs dis_tpu).

The same NumPy inputs go through the JAX function on JAX CPU and its
counterpart in the port on torch CPU (the plain path of kernel K3).

Gates: pads and ``sobel3`` bitwise (same per-element operation order);
``resize_half`` bitwise against the JAX ``window2`` route, whose
association the port uses; ``gradient_magnitude`` and every pyramid
plane to 1e-4 (the magnitude's square root and XLA's CPU fusion differ
by about an ulp; measured max 7.6e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dis_tpu.ops import image as jim
from dis_tpu.ops import pyramid as jpyr
from dis_tpu_torch.ops import image as tim
from dis_tpu_torch.ops import pyramid as tpyr

SHAPES = [(24, 40), (37, 53), (64, 96)]


def _img(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(x.copy())


@pytest.mark.parametrize("shape", SHAPES)
def test_pads_bitwise(shape):
    x = _img(shape, 1)
    jx, tx = _both(x)
    np.testing.assert_array_equal(tim.reflect101_pad(tx, 2).numpy(),
                                  np.asarray(jim.reflect101_pad(jx, 2)))
    np.testing.assert_array_equal(tim.replicate_pad(tx, 1, 2, 3, 4).numpy(),
                                  np.asarray(jim.replicate_pad(jx, 1, 2, 3, 4)))
    np.testing.assert_array_equal(tim.constant_pad(tx, 4, 3, 2, 1).numpy(),
                                  np.asarray(jim.constant_pad(jx, 4, 3, 2, 1)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("axis", ["x", "y"])
def test_sobel3_bitwise(shape, axis):
    x = _img(shape, 2)
    jx, tx = _both(x)
    np.testing.assert_array_equal(tim.sobel3(tx, axis).numpy(),
                                  np.asarray(jim.sobel3(jx, axis)))


@pytest.mark.parametrize("shape", [(24, 40), (64, 96), (136, 240)])
def test_resize_half_bitwise_window2(shape, monkeypatch):
    monkeypatch.setenv("DIS_TPU_RESIZE", "window2")
    x = _img(shape, 3)
    jx, tx = _both(x)
    np.testing.assert_array_equal(tim.resize_half(tx).numpy(),
                                  np.asarray(jim.resize_half(jx)))


def test_resize_half_rejects_odd_dims():
    with pytest.raises(ValueError, match="even dims"):
        tim.resize_half(torch.zeros((5, 8)))


@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_magnitude(shape):
    x = _img(shape, 4)
    jx, tx = _both(x)
    np.testing.assert_allclose(tim.gradient_magnitude(tx).numpy(),
                               np.asarray(jim.gradient_magnitude(jx)),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("out_hw", [(48, 80), (17, 29)])
def test_resize_bilinear(out_hw):
    x = np.random.default_rng(5).normal(size=(24, 40, 2)).astype(np.float32)
    jx, tx = _both(x)
    oh, ow = out_hw
    np.testing.assert_allclose(tim.resize_bilinear(tx, ow, oh).numpy(),
                               np.asarray(jim.resize_bilinear(jx, ow, oh)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(37, 53), (64, 96)])
def test_pad_divisible_and_crop(shape):
    x = _img(shape, 6)
    jx, tx = _both(x)
    tp, tpad = tim.pad_divisible(tx, 3)
    jp, jpad = jim.pad_divisible(jx, 3)
    assert tpad == jpad
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    flow = np.random.default_rng(7).normal(size=tp.shape + (2,)).astype(np.float32)
    np.testing.assert_array_equal(
        tim.crop_padding(torch.from_numpy(flow), *tpad, shape[1], shape[0]).numpy(),
        np.asarray(jim.crop_padding(jnp.asarray(flow), *jpad, shape[1], shape[0])))


@pytest.mark.parametrize("shape,coarsest,p", [((64, 96), 3, 8), ((48, 64), 2, 12)])
def test_construct_pyramid(shape, coarsest, p):
    x = _img(shape, 8)
    jx, tx = _both(x)
    jl = jpyr.construct_pyramid(jx, coarsest, p)
    tl = tpyr.construct_pyramid(tx, coarsest, p)
    assert len(tl) == len(jl) == coarsest + 1
    for a, b in zip(tl, jl):
        assert (a.width, a.height) == (b.width, b.height)
        for pa, pb in zip((a.img, a.dx, a.dy), (b.img, b.dx, b.dy)):
            np.testing.assert_allclose(pa.numpy(), np.asarray(pb), rtol=0, atol=1e-4)
