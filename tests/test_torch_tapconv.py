"""The port's tap-GEMM conv and its PrimaryCaps vs the JAX package, CPU.

Same numpy inputs (seeded) through both packages.  On the CPU the port
runs the plain versions of K3, K4 and K5; the JAX side runs its Pallas
kernels in interpret mode (`tap_conv_valid(x, w, True)`, `_dx_impl`,
`_dw_impl` with interpret=True), as tests/test_tapconv.py does, and its
XLA branch (interpret=False on the CPU).  Shapes are those of
tests/test_tapconv.py plus a 3x5 kernel with Ci != Co.

The bf16 kernels' index plans are replayed in plain torch, f32, and held
to the plain versions within 1e-6 * max|plain| (the same products
summed in another order): K4 tile by tile over `dx_tap_table`'s taps
only (and the table checked minimal and complete by flat indices), K3 as
`fwd_split_plan`'s partial sums added in group order, K5 as `dw_plan`
gives it: the valid-row form per Ci tile, the canvas form per tap group
and split from the B matrix the kernel reads (`canvas_operand`, two
taps a box), the splits' partials added in order.

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
from tests.test_torch_cuda import TAP_CASES
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
    fns = (ttap.tap_conv_fwd, ttap.tap_conv_dx, ttap.tap_conv_dw)
    before = [(fn.launches, dict(fn.launches_by_co)) for fn in fns]
    torch.testing.assert_close(ttap.tap_conv_fwd(x, w), ttap.tap_conv_fwd_plain(x, w),
                               rtol=0, atol=0)
    ttap.tap_conv_dx(g, w, x.shape)
    ttap.tap_conv_dw(x, g, w.shape)
    assert before == [(fn.launches, fn.launches_by_co) for fn in fns]
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


# ------------------------------------------- the bf16 kernels' index plans

# tests/test_torch_cuda.py's kernel shapes (ranks 1-3, ragged canvases)
# and PrimaryCaps' 28^2 -> 20^2 geometry at a narrow Ci
PLAN_CASES = TAP_CASES + [((2, 28, 28, 8), (9, 9, 8, 16))]
PLAN_RTOL = 1e-6  # of max|plain|: the same f32 products summed in another order
H100_SMS = 132  # the SXM card's SMs, which K3's split plans are written for


def _plan_inputs(x_shape, k_shape, seed=5):
    rng = np.random.default_rng(seed)
    od = tuple(d - k + 1 for d, k in zip(x_shape[1:-1], k_shape[:-2]))
    return (torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32) * 0.5),
            torch.from_numpy(rng.standard_normal(k_shape).astype(np.float32) * 0.05),
            torch.from_numpy(rng.standard_normal((x_shape[0], *od, k_shape[-1]))
                             .astype(np.float32)))


def _flat_offsets(sp, kd):
    """off(t) of every tap in row-major order: its flat canvas-row shift."""
    strides = np.cumprod((1,) + tuple(sp[:0:-1]))[::-1]
    return [int(np.dot(t, strides)) for t in np.ndindex(*kd)]


def _assert_plain_close(got, ref, what):
    err = (got - ref).abs().max().item()
    assert err <= PLAN_RTOL * ref.abs().max().item(), (what, err)


def replay_dx_table(g, w, x_shape, table, bm):
    """K4 as the kernel runs it: dx tile by tile, each tile's rows against
    only the taps its table row lists, in order (f32)."""
    sp, kd = tuple(x_shape[1:-1]), tuple(w.shape[:-2])
    Ci, Co = w.shape[-2], w.shape[-1]
    pads = [p for d, o in zip(reversed(sp), reversed(g.shape[1:-1])) for p in (0, d - o)]
    gcan = torch.nn.functional.pad(g, [0, 0] + pads).reshape(-1, Co)
    wt = w.reshape(-1, Ci, Co)
    off = _flat_offsets(sp, kd)
    dx = torch.zeros((gcan.shape[0], Ci))
    for i, row in enumerate(table):
        p = torch.arange(i * bm, min((i + 1) * bm, gcan.shape[0]))
        for t in row[1:1 + row[0]]:
            src = p - off[t]
            a = torch.where((src >= 0)[:, None], gcan[src.clamp(min=0)], 0.0)
            dx[p] += a @ wt[t].T
    return dx.reshape(x_shape[0], *sp, Ci)


def replay_fwd_split(x, w):
    """K3 as the kernel runs it: the flat (tap, ci) reduction cut into
    fwd_split_plan's groups of the tile's steps, each group's f32 partial
    summed in group order."""
    _, kd, od = ttap._geometry(x.shape, w.shape)
    Ci, Co = w.shape[-2], w.shape[-1]
    cols = torch.cat([x[win].reshape(-1, Ci) for _, win in ttap._taps(kd, od)], 1)
    wf = w.reshape(-1, Co)
    bk = ttap.kernel_tile(ttap._FWD, torch.bfloat16, Ci, Co)[2]
    splits, per = ttap.fwd_split_plan(cols.shape[0], Ci, Co, len(list(ttap._taps(kd, od))),
                                      H100_SMS)
    out = None
    for z in range(splits):
        lo, hi = z * per * bk, min((z + 1) * per * bk, cols.shape[1])
        assert lo < hi, "an empty group"
        part = cols[:, lo:hi] @ wf[lo:hi]
        out = part if out is None else out + part
    return out.reshape(x.shape[0], *od, Co), splits


@pytest.mark.parametrize("bm", [ttap._DX_BM, 16])
@pytest.mark.parametrize("x_shape,k_shape", PLAN_CASES)
def test_dx_tap_table_replay_matches_plain(x_shape, k_shape, bm):
    x, w, g = _plan_inputs(x_shape, k_shape)
    table = ttap.dx_tap_table(x_shape[0], x_shape[1:-1], k_shape[:-2], bm)
    _assert_plain_close(replay_dx_table(g, w, x_shape, table, bm),
                        ttap.tap_conv_dx_plain(g, w, x_shape), "K4 tap table")


@pytest.mark.parametrize("bm", [ttap._DX_BM, 16])
@pytest.mark.parametrize("x_shape,k_shape", PLAN_CASES)
def test_dx_tap_table_is_minimal(x_shape, k_shape, bm):
    """A tap is listed for a tile exactly when one of the tile's rows p
    reads a non-zero gcan row p - off(t) (a valid output position), by
    flat canvas indices, independently of the table's coordinates."""
    sp, kd = tuple(x_shape[1:-1]), tuple(k_shape[:-2])
    od = tuple(d - k + 1 for d, k in zip(sp, kd))
    rows = x_shape[0] * int(np.prod(sp))
    src = np.arange(rows)[:, None] - np.array(_flat_offsets(sp, kd))[None]
    coords = np.stack(np.unravel_index(np.clip(src, 0, None) % int(np.prod(sp)), sp), -1)
    nonzero = (src >= 0) & (coords < np.array(od)).all(-1)  # (rows, taps)
    table = ttap.dx_tap_table(x_shape[0], sp, kd, bm)
    assert table.shape == (-(-rows // bm), 1 + len(_flat_offsets(sp, kd)))
    for i, row in enumerate(table):
        want = np.flatnonzero(nonzero[i * bm:(i + 1) * bm].any(0))
        np.testing.assert_array_equal(row[1:1 + row[0]], want, err_msg=f"tile {i}")


@pytest.mark.parametrize("x_shape,k_shape", PLAN_CASES)
def test_fwd_split_replay_matches_plain(x_shape, k_shape):
    x, w, _ = _plan_inputs(x_shape, k_shape)
    out, splits = replay_fwd_split(x, w)
    assert splits > 1  # every case is small against the card: each splits
    _assert_plain_close(out, ttap.tap_conv_fwd_plain(x, w), "K3 split")


def test_split_plan_at_primary_caps_shapes():
    """PrimaryCaps at 28^2 -> 20^2.  The act conv (Co 32): train (B 16) and
    serving (B 14) split into 11 and 12 groups (~8 blocks an SM).  The
    pose conv (Co 512): 100 tiles x 5 groups = 3.79 waves on 132 SMs at
    the train shape, 88 x 3 = 2.0 waves at serving; a card-filling count
    of tiles does not split."""
    assert ttap.fwd_split_plan(16 * 400, 832, 32, 81, H100_SMS) == (11, 96)
    assert ttap.fwd_split_plan(14 * 400, 832, 32, 81, H100_SMS) == (12, 88)
    assert ttap.fwd_split_plan(16 * 400, 832, 512, 81, H100_SMS) == (5, 211)
    assert ttap.fwd_split_plan(14 * 400, 832, 512, 81, H100_SMS) == (3, 351)
    assert ttap.fwd_split_plan(66 * 128, 832, 512, 81, H100_SMS)[0] == 1  # 132 tiles
    # a card with fewer SMs (the PCIe H100's 114) plans for its own count
    assert ttap.fwd_split_plan(16 * 400, 832, 32, 81, 114) == (10, 106)


@pytest.mark.parametrize("dtype,mode,co,tile", [
    (torch.bfloat16, ttap._FWD, 512, (128, 256, 64)),  # K3 pose: wgmma, two warpgroups
    (torch.bfloat16, ttap._FWD, 32, (64, 64, 64)),  # K3 act: one warpgroup, split
    (torch.bfloat16, ttap._DX, 512, (192, 208, 64)),  # K4: N 208 divides Ci 832
    (torch.bfloat16, ttap._DX, 32, (192, 208, 64)),
    (torch.bfloat16, ttap._DW, 512, (128, 256, 64)),  # K5: wgmma, the valid-row form
    (torch.bfloat16, ttap._DW, 32, (128, 256, 64)),  # ... the canvas form
    (torch.float32, ttap._FWD, 32, (128, 32, 16)),  # f32: the FP32-core body
    (torch.float32, ttap._DX, 512, (128, 128, 16)),
])
def test_kernel_tiles_at_primary_caps_shapes(dtype, mode, co, tile):
    """The tiles the wrapper gives csrc/tap_conv.cu at PrimaryCaps' Ci 832
    (the kernel is built for these and refuses others)."""
    assert ttap.kernel_tile(mode, dtype, 832, co) == tile


# K5's plans: PLAN_CASES in each form the kernel takes (the canvas form up
# to Co 64), plus a Co of 40 (the canvas form's one tap a box)
DW_PLAN_CASES = [(x, k, form) for x, k in PLAN_CASES + [((2, 9, 10, 16), (3, 3, 16, 40))]
                 for form in ("rows", "canvas") if form == "rows" or k[-1] <= 64]


def _dw_plan_of(x_shape, k_shape, form):
    return ttap.dw_plan(x_shape[0], x_shape[1:-1], k_shape[:-2], k_shape[-2], k_shape[-1],
                        H100_SMS, form)


def canvas_operand(gcan, co):
    """The B matrix csrc/tap_conv.cu lays out for K5's canvas form
    (tapconv.dw_workspace_bytes), 64 columns a row: for Co <= 32 row r =
    [gcan[r - 1], gcan[r]], each padded to 32 channels (zeros before and
    past the canvas), so that a box row at r = p - off(t) holds tap t + 1's
    row in columns 0-31 and tap t's in 32-63; else gcan padded to 64
    channels."""
    gc = gcan.reshape(-1, co)
    if co > 32:
        return torch.nn.functional.pad(gc, (0, 64 - co))
    gc = torch.nn.functional.pad(gc, (0, 32 - co))
    return torch.cat([torch.nn.functional.pad(gc, (0, 0, 1, 0)),
                      torch.nn.functional.pad(gc, (0, 0, 0, 1))], 1)


def replay_dw_plan(x, g, k_shape, plan):
    """K5 as the kernel runs it (f32).  The valid-row form: each Ci tile
    of every tap's dW over the valid output positions.  The canvas form:
    for each split of the canvas rows (plan.rows_per_split each) and each
    tap group, box by box from the B matrix the kernel reads (for two taps
    (t, t + 1), rows p - off(t): tap t + 1 in columns 0-31, tap t in
    32-63), the splits' partials summed in order."""
    sp, kd = tuple(x.shape[1:-1]), tuple(k_shape[:-2])
    _, _, od = ttap._geometry(x.shape, k_shape)
    Ci, Co = k_shape[-2], k_shape[-1]
    bm = plan.tile[0]
    if plan.form == "rows":
        dw = torch.zeros((len(plan.groups), Ci, Co))
        gm = g.reshape(-1, Co)
        for ((t,),), (_, win) in zip(plan.groups, ttap._taps(kd, od)):
            for c0 in range(0, Ci, bm):
                dw[t, c0:c0 + bm] = x[win][..., c0:c0 + bm].reshape(-1, min(bm, Ci - c0)).T @ gm
        return dw.reshape(*kd, Ci, Co)
    xc = x.reshape(-1, Ci)
    bmat = canvas_operand(ttap._gcan(g, sp, od), Co)
    off = _flat_offsets(sp, kd)
    out = None
    for z in range(plan.splits):
        p = torch.arange(z * plan.rows_per_split, min((z + 1) * plan.rows_per_split, len(xc)))
        assert len(p), "an empty split"
        part = torch.zeros((len(off), Ci, Co))
        for group in plan.groups:
            for box in group:
                r = p - off[box[0]]
                rows = torch.where(((r >= 0) & (r < len(bmat)))[:, None],
                                   bmat[r.clamp(0, len(bmat) - 1)], 0.0)
                cols = [32, 0] if len(box) == 2 else [32 if Co <= 32 else 0]
                for t, c in zip(box, cols):
                    part[t] += xc[p].T @ rows[:, c:c + Co]
        out = part if out is None else out + part
    return out.reshape(*kd, Ci, Co)


@pytest.mark.parametrize("x_shape,k_shape,form", DW_PLAN_CASES)
def test_dw_plan_replay_matches_plain(x_shape, k_shape, form):
    x, _, _ = _plan_inputs(x_shape, k_shape)
    g = _plan_inputs(x_shape, k_shape, seed=6)[2]
    plan = _dw_plan_of(x_shape, k_shape, form)
    assert plan.form == form
    _assert_plain_close(replay_dw_plan(x, g, k_shape, plan),
                        ttap.tap_conv_dw_plain(x, g, k_shape), f"K5 {form}")


@pytest.mark.parametrize("x_shape,k_shape,form", DW_PLAN_CASES)
def test_dw_plan_covers_every_tap_once(x_shape, k_shape, form):
    """Every tap lands in exactly one box of one group; a box of two taps
    holds neighbours t, t + 1 in one row of the last kernel dim (row
    shifts one apart); no group holds more boxes than a block multiplies;
    the splits cover the reduction and none is empty."""
    plan = _dw_plan_of(x_shape, k_shape, form)
    kd = k_shape[:-2]
    taps = [t for group in plan.groups for box in group for t in box]
    assert sorted(taps) == list(range(int(np.prod(kd))))
    for group in plan.groups:
        assert 1 <= len(group) <= (1 if form == "rows" else ttap._DW_BOXES)
        for box in group:
            assert len(box) == 1 or (len(box) == 2 and box[1] == box[0] + 1
                                     and box[1] % kd[-1] != 0 and k_shape[-1] <= 32)
    bk = plan.tile[2]
    positions = x_shape[0] * int(np.prod(x_shape[1:-1] if form == "canvas" else
                                         [d - k + 1 for d, k in zip(x_shape[1:-1], kd)]))
    steps, per = -(-positions // bk), plan.rows_per_split // bk
    assert plan.rows_per_split % bk == 0 and per == -(-steps // plan.splits)
    assert (plan.splits - 1) * per < steps <= plan.splits * per
    table = ttap.dw_box_table(plan) if form == "canvas" else None
    if table is not None:  # the kernel's view of the same plan
        assert table.shape == (len(plan.groups), 1 + 2 * ttap._DW_BOXES)
        for row, group in zip(table, plan.groups):
            assert row[0] == len(group)
            got = [tuple(int(t) for t in row[1 + 2 * u:3 + 2 * u] if t >= 0)
                   for u in range(row[0])]
            assert got == list(group)


def test_dw_plan_at_primary_caps_shapes():
    """PrimaryCaps at 28^2 -> 20^2, Ci 832.  The pose conv (Co 512): the
    valid-row form, no split, 7 Ci tiles x 2 Co tiles x 81 taps = 1134
    blocks on any card.  The act conv (Co 32): the canvas form, 45 boxes
    (four pairs and a single tap in each row of 9) in 12 groups of up to
    4 boxes, split 3 ways on 132 SMs (7 x 12 x 3 = 252 blocks, 1.9 waves)
    and 4 ways on the PCIe H100's 114 (336, 2.9 waves)."""
    for batch in (16, 14):
        for sms in (H100_SMS, 114):
            pose = ttap.dw_plan(batch, (28, 28), (9, 9), 832, 512, sms)
            assert (pose.form, pose.splits, pose.blocks) == ("rows", 1, 1134)
            assert pose.rows_per_split == -(-batch * 400 // 64) * 64
    act = ttap.dw_plan(16, (28, 28), (9, 9), 832, 32, H100_SMS)
    assert act.form == "canvas" and len(act.groups) == 12
    assert [len(gr) for gr in act.groups] == [4] * 11 + [1]
    assert sum(len(box) == 2 for gr in act.groups for box in gr) == 36
    assert (act.splits, act.rows_per_split, act.blocks) == (3, 66 * 64, 252)
    assert ttap.dw_plan(16, (28, 28), (9, 9), 832, 32, 114)[3:] == (4, 49 * 64, 336)
    assert ttap.dw_plan(14, (28, 28), (9, 9), 832, 32, H100_SMS)[3:] == (3, 58 * 64, 252)


@pytest.mark.parametrize("mode,co,ratio", [
    (ttap._FWD, 512, 1.0), (ttap._FWD, 32, 2.0),  # K3: Co 32 padded to 64
    (ttap._DX, 512, 1.8533), (ttap._DX, 32, 1.8748),  # K4: the listed taps
    (ttap._DW, 512, 1.0), (ttap._DW, 32, 2.3230),  # K5: canvas rows, 12 x 256 columns
])
def test_work_ratio_at_the_train_shape(mode, co, ratio):
    """The issued over the useful multiply-adds of each bf16 kernel at
    PrimaryCaps' train shape, from the plans themselves."""
    got = ttap.work_ratio(mode, 16, (28, 28), (9, 9), 832, co, H100_SMS)
    assert got == pytest.approx(ratio, abs=1e-4)
