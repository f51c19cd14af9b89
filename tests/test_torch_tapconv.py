"""The port's tap-GEMM conv and its PrimaryCaps vs the JAX package, CPU.

Same numpy inputs (seeded) through both packages.  On the CPU the port
runs the plain versions of K3, K4 and K5; the JAX side runs its Pallas
kernels in interpret mode (`tap_conv_valid(x, w, True)`, `_dx_impl`,
`_dw_impl` with interpret=True), as tests/test_tapconv.py does, and its
XLA branch (interpret=False on the CPU).  Shapes are those of
tests/test_tapconv.py plus a 3x5 kernel with Ci != Co.

Tolerances:
- f32: values within 1e-5, dx within 1e-4, dW within 1e-3 (rtol 1e-4),
  tests/test_tapconv.py's bounds: sums of the same products in another
  order;
- bf16: both sides sum the same bf16-rounded products in f32 and round
  once, so a bf16 output may land one bf16 ulp of max|ref| away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picad_tpu.models.capsules import PrimaryCaps as JaxPrimaryCaps
from picad_tpu.ops import tapconv as jtap
from picad_tpu_torch.checkpoint.convert import _TO_TORCH, capsnet_key_mapping
from picad_tpu_torch.models.capsules import PrimaryCaps
from picad_tpu_torch.ops import tapconv as ttap
from tests.test_torch_model import few_torch_threads  # noqa: F401

F32_TOL = {"out": dict(atol=1e-5, rtol=0), "dx": dict(atol=1e-4, rtol=0),
           "dw": dict(atol=1e-3, rtol=1e-4)}
BF16_ULP = 2.0**-7  # of max|ref|

# (x shape (B, *spatial, Ci), w shape (*k, Ci, Co))
CASES = {
    "odd_w_3x3": ((2, 10, 9, 8), (3, 3, 8, 16)),  # taps of both parities
    "multi_chunk_5x5": ((2, 18, 16, 8), (5, 5, 8, 8)),  # several TPU row chunks
    "pcaps_9x9": ((1, 12, 12, 16), (9, 9, 16, 8)),  # the PrimaryCaps kernel size
    "k3x5_ci_ne_co": ((2, 9, 11, 24), (3, 5, 24, 16)),  # kh != kw, Ci != Co
    "3d": ((1, 4, 8, 9, 8), (3, 3, 3, 8, 8)),  # rank 3 (tests/test_tapconv.py:131)
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(case, seed=0):
    """x, w and a cotangent g of the output, f32 numpy."""
    xs, ks = CASES[case]
    rng = np.random.default_rng(seed)
    out = (xs[0],) + tuple(d - k + 1 for d, k in zip(xs[1:-1], ks[:-2])) + (ks[-1],)
    return (rng.standard_normal(xs).astype(np.float32) * 0.2,
            rng.standard_normal(ks).astype(np.float32) * 0.1,
            rng.standard_normal(out).astype(np.float32) * 0.3)


def _both(a, dtype):
    """The same numpy array as a JAX and a torch array of `dtype` (both
    round f32 to bf16 to nearest even)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def assert_matches(got: torch.Tensor, ref, dtype, kind, what):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if kind == "dw_f32":  # an f32 output in either type
        dtype, kind = "f32", "dw"
    tol = (F32_TOL[kind] if dtype == "f32"
           else dict(atol=BF16_ULP * float(np.abs(ref).max()), rtol=0))
    np.testing.assert_allclose(got, ref, err_msg=what, **tol)


@pytest.mark.parametrize("branch", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_tap_conv_valid_matches_jax(case, dtype, branch):
    """Values and both gradients (autograd vs jax.vjp, same cotangent)."""
    x, w, g = _inputs(case)
    (xj, xt), (wj, wt), (gj, gt) = _both(x, dtype), _both(w, dtype), _both(g, dtype)
    interpret = branch == "pallas_interpret"
    out_j, vjp = jax.vjp(lambda x, w: jtap.tap_conv_valid(x, w, interpret), xj, wj)
    dx_j, dw_j = vjp(gj)

    xt.requires_grad_(True)
    wt.requires_grad_(True)
    out_t = ttap.tap_conv_valid(xt, wt)
    assert out_t.dtype == xt.dtype
    dx_t, dw_t = torch.autograd.grad(out_t, (xt, wt), gt)
    assert dx_t.dtype == dw_t.dtype == xt.dtype
    assert_matches(out_t, out_j, dtype, "out", "out")
    assert_matches(dx_t, dx_j, dtype, "dx", "dx")
    assert_matches(dw_t, dw_j, dtype, "dw", "dW")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_gradients_match_pallas_interpret(case, dtype):
    """The plain K4 and K5 against the TPU kernels themselves
    (`_dx_impl`, `_dw_impl` in interpret mode), given the same g.  dW is
    f32 on both sides, so it takes the f32 bound in either type."""
    x, w, g = _inputs(case, seed=1)
    (xj, xt), (wj, wt), (gj, gt) = _both(x, dtype), _both(w, dtype), _both(g, dtype)
    dx_j = jtap._dx_impl(gj, wj, xj.shape, interpret=True)
    dw_j = jtap._dw_impl(xj, gj, wj.shape, interpret=True)
    dx_t = ttap.tap_conv_dx(gt, wt, tuple(xt.shape))
    dw_t = ttap.tap_conv_dw(xt, gt, tuple(wt.shape))
    assert dx_t.dtype == xt.dtype and dw_t.dtype == torch.float32
    assert_matches(dx_t, dx_j, dtype, "dx", "dx")
    assert_matches(dw_t, dw_j, dtype, "dw_f32", "dW")


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """CPU tensors never launch: the counters stay where they were."""
    x, w, g = (torch.from_numpy(a) for a in _inputs("k3x5_ci_ne_co", seed=2))
    before = (ttap.tap_conv_fwd.launches, ttap.tap_conv_dx.launches, ttap.tap_conv_dw.launches)
    torch.testing.assert_close(ttap.tap_conv_fwd(x, w), ttap.tap_conv_fwd_plain(x, w),
                               rtol=0, atol=0)
    ttap.tap_conv_dx(g, w, x.shape)
    ttap.tap_conv_dw(x, g, w.shape)
    assert before == (ttap.tap_conv_fwd.launches, ttap.tap_conv_dx.launches,
                      ttap.tap_conv_dw.launches)
    with pytest.raises(ValueError, match="one rank"):
        ttap.tap_conv_valid(x, w[0])
    with pytest.raises(ValueError, match="larger than the input"):
        ttap.tap_conv_valid(x[:, :2], w)


# --------------------------------------------------------- PrimaryCaps

CIN, MAP = 64, 12  # 12^2 -> 4^2 output


def _primary_caps_params(seed):
    """JAX PrimaryCaps parameters (normal(0.1) kernels as its init, small
    uniform biases), f32 numpy."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal
    return {"pose_kernel": (k((9, 9, CIN, 512)) * 0.1).astype(np.float32),
            "pose_bias": rng.uniform(-0.01, 0.01, 512).astype(np.float32),
            "a_kernel": (k((9, 9, CIN, 32)) * 0.1).astype(np.float32),
            "a_bias": rng.uniform(-0.01, 0.01, 32).astype(np.float32)}


def _port_state_dict(params):
    """The JAX parameters in the port's layout, by checkpoint/convert.py's
    own mapping rows for PrimaryCaps."""
    prefix = "primary_caps."
    return {key[len(prefix):]: torch.tensor(_TO_TORCH[kind](params[path[-1]]))
            for key, kind, path in capsnet_key_mapping() if key.startswith(prefix)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_primary_caps_matches_jax(dtype):
    """Output and the gradients of x and of the four parameters, cin 64 at
    12^2, the same weights through the converter.  The JAX module runs its
    XLA branch (the CPU default); the port its plain tap sums."""
    jd, td = DTYPES[dtype]
    params = _primary_caps_params(seed=3)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, MAP, MAP, CIN)) * 0.2).astype(np.float32)
    g = (rng.standard_normal((2, MAP - 8, MAP - 8, 544)) * 0.3).astype(np.float32)

    m = JaxPrimaryCaps(compute_dtype=jd)
    out_j, vjp = jax.vjp(lambda p, x: m.apply({"params": p}, x),
                         jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    dp_j, dx_j = vjp(jnp.asarray(g))

    pc = PrimaryCaps(cin=CIN, compute_dtype=td)
    pc.load_state_dict(_port_state_dict(params), strict=True)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_(True)
    out_t = pc(xt)
    assert out_t.shape == (2, MAP - 8, MAP - 8, 544) and out_t.dtype == torch.float32
    names = ("pose.weight", "pose.bias", "a.weight", "a.bias")
    grads = torch.autograd.grad(out_t, [xt] + [pc.get_parameter(n) for n in names],
                                torch.from_numpy(g))
    assert_matches(out_t, out_j, dtype, "out", "output")
    assert_matches(grads[0].permute(0, 2, 3, 1), dx_j, dtype, "dx", "dx")
    dp_t = _port_state_dict(jax.tree.map(np.asarray, dp_j))
    for name, got in zip(names, grads[1:]):
        kind = "dw" if name.endswith("weight") else "dx"
        assert_matches(got, dp_t[name], dtype, kind, name)
