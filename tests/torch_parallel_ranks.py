"""Rank bodies of tests/test_torch_parallel.py: each runs in a process
that `run_ranks` spawns, joins a gloo group on the CPU, and writes what
it computed to `<out_dir>/<rank>.pt` for the test to hold against the
single-process results.  No JAX here: the ranks import only the port."""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

import picad_tpu_torch.models.capsules as port_capsules
import picad_tpu_torch.models.layers as layers
from picad_tpu_torch.config import LossConfig
from picad_tpu_torch.ops.bn_stats import group_stats
from picad_tpu_torch.parallel import mesh
from picad_tpu_torch.train.state import create_train_state
from picad_tpu_torch.train.step import compute_losses, make_train_step

RANK_TIMEOUT_S = 240  # each spawn's own limit


def run_ranks(task: str, world: int, out_dir: str, payload, device: str = "cpu") -> list:
    """Run TASKS[task](rank, world, payload) on `world` gloo ranks, every
    rank on `device` (the CPU, or one card for all); the ranks' results
    in rank order."""
    init = f"tcp://localhost:{mesh.free_port()}"
    mesh.launch(_rank_main, world, (world, init, str(out_dir), task, payload, device),
                timeout=RANK_TIMEOUT_S)
    return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False,
                       map_location="cpu") for r in range(world)]


def _rank_main(r, world, init, out_dir, task, payload, device):
    torch.set_num_threads(1)
    mesh.initialize_distributed(init, world, r, device=device, backend="gloo")
    try:
        if device != "cpu":
            payload = dict(payload, device=device)
        result = TASKS[task](r, world, payload)
        torch.save(result, os.path.join(out_dir, f"{r}.pt"))
    finally:
        dist.destroy_process_group()


def sync_bn(x: torch.Tensor, dy: torch.Tensor, groups: int, onepass_min: int):
    """A train-mode TorchBatchNorm (fixed affine) and `group_stats` on x
    with an upstream gradient dy: (y, dx, dweight, dbias, running stats,
    mean, var, dx of the stats' probe loss).  Runs in or out of a group."""
    saved, layers.BN_ONEPASS_MIN = layers.BN_ONEPASS_MIN, onepass_min
    try:
        return _sync_bn_at(x, dy, groups)
    finally:
        layers.BN_ONEPASS_MIN = saved


def _sync_bn_at(x, dy, groups):
    C = x.shape[1]
    bn = layers.TorchBatchNorm(C, stats_groups=groups).to(x.device)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, C))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, C))
    x = x.clone().requires_grad_()
    y = bn(x)
    (y * dy).sum().backward()
    out = {"y": y.detach(), "dx": x.grad.clone(), "dweight": bn.weight.grad.clone(),
           "dbias": bn.bias.grad.clone(), "running_mean": bn.running_mean.clone(),
           "running_var": bn.running_var.clone()}
    x.grad = None
    mean, var = mesh.global_stats(*group_stats(x, groups))
    probe = torch.linspace(-1.0, 1.0, mean.numel(), device=x.device).reshape(mean.shape)
    (mean * probe + var * probe.flip(0)).sum().backward()
    out.update(mean=mean.detach(), var=var.detach(), dx_stats=x.grad.clone())
    return {k: v.cpu() for k, v in out.items()}


def view_rows(a, r: int, world: int, groups: int = 2):
    """Rank r's rows of a batch of `groups` stacked views (the single
    process's [view 0 rows; view 1 rows]): its block of each view."""
    g = a.reshape(groups, world, a.shape[0] // (groups * world), *a.shape[1:])
    return g[:, r].reshape(-1, *a.shape[1:])


def from_views(parts, groups: int = 2):
    """The inverse of `view_rows`: the ranks' rows in the single order."""
    w = len(parts)
    g = torch.stack([p.reshape(groups, -1, *p.shape[1:]) for p in parts], dim=1)
    return g.reshape(-1, *parts[0].shape[1:]) if w else g


def _sync_bn(r, world, p):
    x, dy = (view_rows(torch.from_numpy(a), r, world).to(p.get("device", "cpu"))
             for a in (p["x"], p["dy"]))
    return {path: sync_bn(x, dy, p["groups"], path_min) for path, path_min in
            (("onepass", 0), ("twopass", 1 << 62))}


def losses(seg, flip, scores, seg_gt, action, flags, row_mask):
    """compute_losses at bv and gv on these rows: each metric, and the
    gradients of the total w.r.t. the three differentiable inputs."""
    cfg = LossConfig(bv=True, gv=True, n_frames=5, wt_cons=0.1, loc_loss="dice")
    out = {}
    for loc in ("dice", "iou"):
        cfg.loc_loss = loc
        ins = [t.clone().requires_grad_() for t in (seg, flip, scores)]
        total, metrics = compute_losses(*ins, seg_gt, action, flags, row_mask, cfg, 0.5)
        total.backward()
        out[loc] = {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
                    "grads": [t.grad.clone() for t in ins]}
    return out


def _losses(r, world, p):
    lo, hi = p["splits"][r], p["splits"][r + 1]  # uneven, one rank all padding
    t = {k: torch.from_numpy(v[lo:hi]) for k, v in p.items() if k != "splits"}
    return losses(t["seg"], t["flip"], t["scores"], t["seg_gt"], t["action"].long(),
                  t["flags"], t["row_mask"])


@contextlib.contextmanager
def routing_eps(eps: float):
    """The port's EM routing at `eps` inside the block."""
    fn = port_capsules.em_routing
    port_capsules.em_routing = lambda *a, **k: fn(*a, **{**k, "eps": eps})
    try:
        yield
    finally:
        port_capsules.em_routing = fn


def train_step(sd, batch, loss_cfg: dict, epoch: float, eps: float, remat: bool = False):
    """One port step at bn_groups=2, f32, dropout 0, routing at `eps`
    (`remat`: the encoder's activation checkpoint): (metrics, gradients,
    parameters and buffers after the step)."""
    state = create_train_state(state_dict=sd, device="cpu", compute_dtype=torch.float32,
                               bn_groups=2, dropout_rate=0.0, remat_encoder=remat)
    with routing_eps(eps):
        state, mt = make_train_step(LossConfig(**loss_cfg), device="cpu")(state, batch, epoch,
                                                                          0.5)
    m = state.model
    return ({k: float(v) for k, v in mt.items()},
            {n: p.grad.clone() for n, p in m.named_parameters()},
            {n: p.detach().clone() for n, p in m.named_parameters()},
            {n: b.clone() for n, b in m.named_buffers()})


def _train_step(r, world, p):
    sd = torch.load(p["sd_file"], weights_only=False)
    metrics, grads, params, bufs = train_step(
        sd, mesh.local_rows(p["batch"], r, world), p["loss_cfg"], p["epoch"], p["eps"])
    # identical on every rank iff the ranks' elementwise max and min agree
    flat = torch.cat([t.reshape(-1) for t in (*params.values(), *bufs.values())])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    out = {"metrics": metrics, "same_on_all_ranks": bool(torch.equal(hi, lo))}
    if r == 0:  # the rest is the same on every rank
        out.update(grads=grads, params=params, buffers=bufs)
        # the encoder rematerialized: its BN forwards, collectives included,
        # rerun inside the backward, with one running-stat update
        m, g, _, b = train_step(sd, mesh.local_rows(p["batch"], r, world), p["loss_cfg"],
                                p["epoch"], p["eps"], remat=True)
        out["remat"] = {"metrics": m, "grads": g, "buffers": b}
    else:
        train_step(sd, mesh.local_rows(p["batch"], r, world), p["loss_cfg"], p["epoch"],
                   p["eps"], remat=True)
    return out


def _all(r, world, payloads):
    """Every task of `payloads` ({task: payload}) in one spawn."""
    return {task: TASKS[task](r, world, p) for task, p in payloads.items()}


TASKS = {"sync_bn": _sync_bn, "losses": _losses, "train_step": _train_step, "all": _all}
