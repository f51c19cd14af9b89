"""The bf16 composite-ConvT kernels' plans, replayed in plain torch.

csrc/composite_convt.cu (K1) and csrc/composite_convt_bwd.cu (K2) run
only on the card.  What they compute follows from what the wrappers hand
them: K1's operand Bop (`fwd_operand`) and plan (`fwd_plan`), K2's tap
table (`bwd_tap_table`) and split plan (`bwd_plan`).  These tests replay
both kernels' arithmetic from those, tile by tile, in float64, and hold
the result against the plain versions (`composite_convt_plain`,
`composite_convt_bwd_plain`) to 1e-12 of the largest value.
"""

import itertools
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from picad_tpu_torch.ops import _build
from picad_tpu_torch.ops import fused_head_kernel as fhk

RTOL = 1e-12  # of max|plain|: float64 sums of the same products in another order

# ragged shapes: T = 1, H = 1, W = 1, W past one w-tile (K1 owns 126
# outputs a tile, K2 128 positions), C past one 128-channel block
SHAPES = [
    (1, 1, 1, 1, 8),
    (2, 3, 5, 7, 16),
    (1, 2, 3, 130, 8),
    (1, 1, 2, 253, 8),
    (1, 2, 2, 9, 136),
]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    B, T, H, W, C = shape
    x = torch.from_numpy(rng.standard_normal(shape))
    Kc = torch.from_numpy(0.1 * rng.standard_normal((B, 5, 5, 5, C)))
    g = torch.from_numpy(rng.standard_normal((B, 2 * T, 2 * H, 2 * W)))
    return x, Kc, g


def _assert_close(got, ref):
    assert got.shape == ref.shape
    err = (got - ref).abs().max().item()
    assert err <= RTOL * ref.abs().max().item(), err


def replay_fwd(x, Kc):
    """K1's arithmetic at its plan: for each w-tile, output row h' and x
    frame t, the products of the 128-position x rows (t, h' + s_h) from
    w0 - 1 with Bop's 72 columns at s_h (its 3 s_t), each 24-column block
    added to the partial sums of frame t' = t - s_t; then the w-fold of
    each frame's sums; channel groups summed in order."""
    B, T, H, W, C = x.shape
    plan = fhk.fwd_plan(B, T, H, W, C)
    tile, own = fhk._FWD_TILE, fhk._FWD_OWN
    bop = fhk.fwd_operand(Kc, x.dtype).reshape(B, 3, fhk._FWD_NT, C)  # (s_h, (s_t, n))
    # a w-tile's rows are x[w0 - 1 .. w0 + 127), zero outside x
    xp = F.pad(x, (0, 0, 1, max(0, plan.w_starts[-1] + tile - 1 - W)))
    out = torch.zeros((B, 2 * T, 2 * H, 2 * W), dtype=x.dtype)
    for grp in range(plan.groups):
        part = torch.zeros_like(out)
        cs = slice(grp * fhk._CHUNK, (grp + 1) * fhk._CHUNK)
        for b, hp, w0 in itertools.product(range(B), range(H), plan.w_starts):
            sums = torch.zeros((T, tile, fhk._FWD_N), dtype=x.dtype)
            for t, sh in itertools.product(range(T), (-1, 0, 1)):
                if 0 <= hp + sh < H:
                    prod = xp[b, t, hp + sh, w0:w0 + tile, cs] @ bop[b, sh + 1, :, cs].T
                    for st in (-1, 0, 1):
                        if 0 <= t - st < T:
                            sums[t - st] += prod[:, (st + 1) * fhk._FWD_N:(st + 2) * fhk._FWD_N]
            for tp in range(T):
                z = sums[tp, :, :20].reshape(tile, 4, 5)  # (row j = w - w0 + 1, 2 phi_t + phi_h, tau_w)
                n = min(own, W - w0)  # outputs w' = w0 + j - 1, rows j = 1 .. n
                ph0 = z[2:n + 2, :, 0] + z[1:n + 1, :, 2] + z[0:n, :, 4]
                ph1 = z[2:n + 2, :, 1] + z[1:n + 1, :, 3]
                for pp in range(4):
                    row = part[b, 2 * tp + pp // 2, 2 * hp + pp % 2]
                    row[2 * w0:2 * (w0 + n):2] = ph0[:, pp]
                    row[2 * w0 + 1:2 * (w0 + n):2] = ph1[:, pp]
        out += part
    return out


def replay_bwd(g, x, Kc, sms):
    """K2's arithmetic at its plan: G tiles (128 taps x 128 positions of
    one row, w from 128 wt) built from the phase-split g through the tap
    table; dx = G^T Kc; the dKc partials of each split's tile range,
    summed in split order."""
    B, T, H, W, C = x.shape
    plan = fhk.bwd_plan(B, T, H, W, C, sms)
    tile = fhk._BWD_TILE
    table = torch.from_numpy(fhk.bwd_tap_table()).long()  # (125, axis, (rho, m))
    # phase planes: P[b, rho_t, rho_h, rho_w, 1 + j_t, 1 + j_h, 1 + j_w] = g[b, 2j + rho]
    P = g.to(x.dtype).reshape(B, T, 2, H, 2, W, 2).permute(0, 2, 4, 6, 1, 3, 5)
    P = F.pad(P, (1, plan.w_tiles * tile + 2 - W, 1, 1, 1, 1))
    kc = Kc.to(x.dtype).reshape(B, fhk._NTAPS, C)
    xw = F.pad(x, (0, 0, 0, plan.w_tiles * tile - W))  # rows past W read as zeros
    dx = torch.zeros_like(x)
    dkc = torch.zeros((B, fhk._NTAPS, C), dtype=x.dtype)
    pos = torch.arange(tile)
    for b in range(B):
        parts = []
        for s in range(plan.splits):
            part = torch.zeros((fhk._NTAPS, C), dtype=x.dtype)
            for q in range(s * plan.per, min(plan.tiles, (s + 1) * plan.per)):
                h, rest = q % H, q // H
                t, w0 = rest // plan.w_tiles, rest % plan.w_tiles * tile
                r, m = table[..., 0], table[..., 1]  # (125, 3)
                G = P[b, r[:, 0, None], r[:, 1, None], r[:, 2, None], t + m[:, 0, None],
                      h + m[:, 1, None], w0 + pos + m[:, 2, None]]  # (125 taps, 128 positions)
                n = min(tile, W - w0)
                dx[b, t, h, w0:w0 + n] = (G.T @ kc[b])[:n]
                part += G @ xw[b, t, h, w0:w0 + tile]
            parts.append(part)
        for part in parts:  # split order
            dkc[b] += part
    return dx, dkc.reshape(B, 5, 5, 5, C)


@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_replay_matches_plain(shape):
    """Bop's 9 shifted products, the w-fold and the w-tiles with their
    halo give composite_convt_plain."""
    x, Kc, _ = _inputs(shape, seed=11)
    _assert_close(replay_fwd(x, Kc), fhk.composite_convt_plain(x, Kc))


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_replay_matches_plain(shape, sms):
    """G from the phase-split g through the tap table, dx, and the
    per-split dKc partials summed in plan order give
    composite_convt_bwd_plain."""
    x, Kc, g = _inputs(shape, seed=12)
    dx, dkc = replay_bwd(g, x, Kc, sms)
    dx_ref, dkc_ref = fhk.composite_convt_bwd_plain(g, x, Kc)
    _assert_close(dx, dx_ref)
    _assert_close(dkc, dkc_ref)


def test_bwd_tap_table_builds_the_gathered_view():
    """G[i, tau] = gphase_rho[i + m - 1] per axis is the plain version's
    unfolded view g[2i - 2 + tau]; every tap appears once."""
    table = fhk.bwd_tap_table()
    taus = 2 * table[..., 1] + table[..., 0]  # (125, 3)
    assert sorted(map(tuple, taus.tolist())) == list(itertools.product(range(5), repeat=3))
    assert (table[..., 0] < 2).all() and (table[..., 1] < 3).all()
    for tau, (t, h, w) in enumerate(taus.tolist()):
        assert tau == 25 * t + 5 * h + w
    _, _, g = _inputs((1, 2, 3, 4, 8), seed=13)
    gp = F.pad(g, (2, 1, 2, 1, 2, 1))
    G_ref = gp.unfold(1, 5, 2).unfold(2, 5, 2).unfold(3, 5, 2).reshape(1, 2, 3, 4, 125)
    r, m = table[..., 0], table[..., 1]
    P = F.pad(g.reshape(1, 2, 2, 3, 2, 4, 2).permute(0, 2, 4, 6, 1, 3, 5), (1, 1) * 3)
    for i in itertools.product(range(2), range(3), range(4)):
        G = P[0, r[:, 0], r[:, 1], r[:, 2], i[0] + m[:, 0], i[1] + m[:, 1], i[2] + m[:, 2]]
        torch.testing.assert_close(G, G_ref[(0, *i)], rtol=0, atol=0)


@pytest.mark.parametrize("W", [1, 7, 112, 126, 127, 252, 253, 300])
def test_fwd_plan_owns_every_output_once(W):
    plan = fhk.fwd_plan(1, 2, 3, W, 8)
    owned = [w for w0 in plan.w_starts for w in range(w0, min(W, w0 + fhk._FWD_OWN))]
    assert owned == list(range(W))
    # each tile's input rows w0 - 1 .. w0 + 126 cover its outputs' taps w' - 1 .. w' + 1
    assert fhk._FWD_OWN + 2 == fhk._FWD_TILE


def test_fwd_operand_columns():
    """Bop's columns: a shift feeds phase phi_t (phi_h) only through
    _PHASE_TAPS; 20 columns a shift are taps, the rest the zero row."""
    idx = fhk.fwd_operand_index().reshape(9, fhk._FWD_N)
    assert (idx[:, 20:] == fhk._NTAPS).all()
    for si, (st, sh) in enumerate(fhk._SHIFTS):  # s = -1 feeds phase 0 only
        live = 5 * (1 if st == -1 else 2) * (1 if sh == -1 else 2)
        assert (idx[si] < fhk._NTAPS).sum() == live
    # each tap reaches one output phase from one shift: one column in all
    counts = np.bincount(idx[idx < fhk._NTAPS], minlength=fhk._NTAPS)
    assert (counts == 1).all()
    Kc = torch.arange(2 * 125 * 8, dtype=torch.float32).reshape(2, 5, 5, 5, 8)
    bop = fhk.fwd_operand(Kc, torch.bfloat16)
    assert bop.shape == (2, 9 * fhk._FWD_N, 8) and bop.dtype == torch.bfloat16
    assert bop.is_contiguous()


@pytest.mark.parametrize("shape", [(16, 4, 112, 112, 128), (14, 4, 112, 112, 128)] + SHAPES)
def test_fwd_plan_work_ratio_counts_the_blocks_products(shape):
    """fwd_plan's issued work, by enumerating the blocks' products: each
    frame, x rows h in [h0 - 1, h0 + R] inside x, a _FWD_NT-column product
    for each row h' of the block within one of h."""
    B, T, H, W, C = shape
    plan = fhk.fwd_plan(*shape)
    products = 0
    for h0 in range(0, H, plan.rows):
        for h in range(max(0, h0 - 1), min(H, h0 + plan.rows + 1)):
            products += T * sum(abs(h - hp) <= 1 for hp in range(h0, min(H, h0 + plan.rows)))
    issued = products * fhk._FWD_NT * B * len(plan.w_starts) * fhk._FWD_TILE * 64 * -(-C // 64)
    assert plan.work_ratio == pytest.approx(issued / (B * T * H * W * C * 125), rel=1e-12)
    assert plan.blocks == B * plan.groups * plan.row_blocks * len(plan.w_starts)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", [(16, 4, 112, 112, 128), (200, 1, 1, 1, 8), (3, 1, 1, 300, 264)]
                         + SHAPES)
def test_bwd_plan_splits_are_never_empty(shape, sms):
    plan = fhk.bwd_plan(*shape, sms)
    B, T, H, W, C = shape
    assert plan.tiles == T * H * -(-W // fhk._BWD_TILE)
    assert plan.splits >= 1 and (plan.splits - 1) * plan.per < plan.tiles <= plan.splits * plan.per
    assert plan.blocks == plan.splits * plan.chunks * B
    if B * plan.chunks <= sms:
        assert plan.blocks <= sms  # one wave of one block an SM


def test_plans_at_the_train_shape():
    """The numbers PERF.md quotes: K1 896 blocks, work ratio 1.963; K2 8
    splits of 56 tiles on 132 SMs, 7 of 64 on 114."""
    k1 = fhk.fwd_plan(16, 4, 112, 112, 128)
    assert (k1.w_starts, k1.rows, k1.groups, k1.blocks) == ((0,), 2, 1, 896)
    assert k1.work_ratio == pytest.approx(1.9631, abs=1e-4)
    assert fhk.bwd_plan(16, 4, 112, 112, 128, 132)[3:6] == (8, 56, 128)
    assert fhk.bwd_plan(16, 4, 112, 112, 128, 114)[3:6] == (7, 64, 112)


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edit to csrc/hopper.cuh changes every library's path: no stale
    build is served after a header edit."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.kernel_names()}
    assert before == {n: _build.library_path(n) for n in _build.kernel_names()}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.kernel_names()}
    assert all(after[n] != before[n] for n in before)
    (csrc / "bn_stats.cu").write_text((csrc / "bn_stats.cu").read_text() + "\n")
    assert _build.library_path("bn_stats") != after["bn_stats"]
    assert _build.library_path("tap_conv") == after["tap_conv"]
