"""The shared product's plain version (`ops/fused_linear.py`) against the JAX
package on the CPU: the same numpy inputs through the TPU kernels' own product
helpers (`_ln`, `_linear`, `_gelu_exact` of `ops/swin_block_fused.py`, which
every fused TPU kernel computes its products with) and through the port; the
gathers against the JAX package's window layouts and transition permutation.
On the CPU the port's wrapper takes the plain version.

Tolerances: fp32 2e-5 (summation order; the TPU kernel's polynomial erf,
|err| <= 3e-7, against the exact erf here); bf16 2e-2 (both sides round at
the same places: a difference is one bf16 ulp, 2^-8 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch.ops import fused_linear as fl
from on_device_image_captioning_tpu.models import swin as jswin
from on_device_image_captioning_tpu.ops import swin_block_fused as jsbf

TOL = {np.float32: 2e-5, jnp.bfloat16: 2e-2}
DTYPES = {np.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(rows, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32),
            (rng.standard_normal(n) * 0.2).astype(np.float32),
            (1.0 + 0.2 * rng.standard_normal(k)).astype(np.float32),
            (0.2 * rng.standard_normal(k)).astype(np.float32))


def _port(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(DTYPES[dtype])


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("gelu", [False, True])
def test_product_matches_the_tpu_kernels_helpers(dtype, gelu):
    """LayerNorm prologue, bias, GELU: _gelu_exact(_linear(_ln(x)))."""
    x, w, b, g, beta = _inputs(40, 64, 48, 3)
    want = jsbf._linear(jsbf._ln(jnp.asarray(x, dtype), g, beta, 1e-5),
                        jnp.asarray(w, dtype), b)
    if gelu:
        want = jsbf._gelu_exact(want.astype(jnp.float32)).astype(dtype)
    got = fl.fused_linear(_port(x, dtype), _port(w, dtype), torch.from_numpy(b),
                          (torch.from_numpy(g), torch.from_numpy(beta)), gelu=gelu)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_product_residual_with_row_scale(dtype):
    """The residual epilogue with each image's scale on the rounded product:
    round(res + m * round(x @ w + b)), as the TPU training forwards."""
    x, w, b, _, _ = _inputs(32, 64, 64, 4)
    res = np.random.default_rng(5).standard_normal((32, 64)).astype(np.float32)
    m = np.array([0.0, 1.25], np.float32)
    lin = jsbf._linear(jnp.asarray(x, dtype), jnp.asarray(w, dtype), b)
    want = (jnp.asarray(res, dtype).astype(jnp.float32)
            + jnp.repeat(m, 16)[:, None] * lin.astype(jnp.float32)).astype(dtype)
    got = fl.fused_linear(_port(x, dtype), _port(w, dtype), torch.from_numpy(b),
                          resid=_port(res, dtype), row_scale=torch.from_numpy(m))
    _close(got, want, dtype)


@pytest.mark.parametrize("res, window", [(8, 4), (16, 4)])
def test_merge_gather_matches_the_jax_layouts(res, window):
    """gather ("merge", res, window): output row r's four rows side by side
    along K, in the reference's concat order (even, even), (odd, even),
    (even, odd), (odd, odd) of the 2x2 patch, both grids in window layout
    (the JAX package's `_window_reverse` / `_window_partition`), here with an
    identity weight."""
    c, images = 8, 2
    rows = images * res * res
    x = np.random.default_rng(res).standard_normal((rows, c)).astype(np.float32)
    got = fl.fused_linear(torch.from_numpy(x), torch.eye(4 * c), m=rows // 4,
                          gather=("merge", res, window, 0))
    grid = jswin._window_reverse(jnp.asarray(x).reshape(-1, window * window, c), window, res,
                                 res)
    merged = jnp.concatenate([grid[:, 0::2, 0::2], grid[:, 1::2, 0::2], grid[:, 0::2, 1::2],
                              grid[:, 1::2, 1::2]], axis=-1)
    want = jswin._window_partition(merged, window).reshape(rows // 4, 4 * c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("from_shift, to_shift", [(0, 2), (2, 0)])
def test_transition_gathers_match_the_jax_permutation(from_shift, to_shift):
    """gather and resid_gather ("transition", ...): rows read where the JAX
    package's transition puts them (`models/swin.py::window_transition_perm`)."""
    res, window, c = 8, 4, 8
    rows = 2 * res * res
    rng = np.random.default_rng(from_shift)
    x, r = (rng.standard_normal((rows, c)).astype(np.float32) for _ in range(2))
    trans = ("transition", res, window, (to_shift - from_shift) % res)
    got = fl.fused_linear(torch.from_numpy(x), torch.eye(c), resid=torch.from_numpy(r),
                          gather=trans, resid_gather=trans)
    perm = np.asarray(jswin.window_transition_perm(res, window, from_shift, to_shift))
    want = (x.reshape(2, -1, c)[:, perm] + r.reshape(2, -1, c)[:, perm]).reshape(rows, c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
