"""The port's config, CLI parsing and ramp schedules vs the JAX package's.

For the same argv both packages' parsers give the same namespace and
`args_to_config` the same `dataclasses.asdict`; `validate()` raises on
the same bad flags (as tests/test_jhmdb_e2e.py:18-28 gates the JAX
config); the six consistency-ramp schedules agree on an epoch grid; and
the multi-card flags raise in the port instead of running on one card.
"""

import dataclasses

import numpy as np
import pytest

import picad_tpu.config as jax_config
import picad_tpu.objectives.ramp_ups as jax_ramps
import picad_tpu_torch.config as port_config
import picad_tpu_torch.objectives.ramp_ups as port_ramps
from picad_tpu.cli.common import args_to_config as j_args_to_config
from picad_tpu.cli.common import build_parser as j_build_parser
from picad_tpu_torch.cli.common import (
    args_to_config,
    build_parser,
    maybe_initialize_distributed,
)
from tests.test_torch_model import few_torch_threads  # noqa: F401

NON_DEFAULT = ["--bs", "8", "--epochs", "100", "--lr", "1e-4", "--pf", "7", "--wt_cls", "0.5",
               "--wt_cons", "0.1", "--const_loss", "jsd", "--seed", "3", "--thresh_epoch", "5",
               "--workers", "3", "--n_frames", "5", "--bv", "--predict_maps", "--bv_wt", "0.3",
               "--gv", "--lower_thresh", "0.1", "--upper_thresh", "0.9", "--gv_wt", "0.7",
               "--decoder", "skvideo", "--data_root", "/d", "--mask_root", "/m",
               "--annotation_root", "/a", "--save_root", "/s", "--compute_dtype", "float32",
               "--no_fold_flip", "--exp_id", "x", "--wandb", "--watch", "--resume", "/r",
               "--decoded_cache_dir", "/c", "--video_cache_gb", "1.5", "--device_cache_gb", "2",
               "--profile_dir", "/p", "--pretrained_i3d_path", "/i.pt", "--cyclic"]
ARGV = {
    "ucf101-default": ("ucf101", []),
    "ucf101-synthetic": ("ucf101", ["--synthetic", "--bs", "4"]),
    "ucf101-flags": ("ucf101", NON_DEFAULT + ["--loc_loss", "iou", "--wt_loc", "2",
                                              "--pkl_file_label", "l.pkl",
                                              "--pkl_file_unlabel", "u.pkl"]),
    "jhmdb-default": ("jhmdb", []),
    "jhmdb-synthetic": ("jhmdb", ["--synthetic", "--bs", "4", "--epochs", "1"]),
    "jhmdb-flags": ("jhmdb", NON_DEFAULT + ["--seg_loss", "iou", "--wt_seg", "3",
                                            "--channel_order", "rgb"]),
}


@pytest.mark.parametrize("case", sorted(ARGV))
def test_args_to_config_matches_jax(case):
    dataset, argv = ARGV[case]
    args, j_args = build_parser(dataset).parse_args(argv), j_build_parser(dataset).parse_args(argv)
    assert vars(args) == vars(j_args)  # the same flags and defaults
    cfg, j_cfg = args_to_config(args, dataset), j_args_to_config(j_args, dataset)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    assert cfg.model.num_classes == (24 if dataset == "ucf101" else 21)
    assert cfg.keep_all_after_epoch == (20 if dataset == "ucf101" else 4)  # main_*.py e<20 / e<4


@pytest.mark.parametrize("name", ["DataConfig", "ModelConfig", "OptimConfig", "LossConfig",
                                  "ParallelConfig", "TrainConfig", "EvalConfig"])
def test_config_defaults_match_jax(name):
    assert dataclasses.asdict(getattr(port_config, name)()) == \
        dataclasses.asdict(getattr(jax_config, name)())


BAD = {
    "odd-bs": (["--bs", "3"], None),
    "loc-loss": (["--loc_loss", "bce"], None),
    "const-loss": (["--const_loss", "kl"], None),
    "n-frames": (["--n_frames", "4"], None),
    "compute-dtype": (["--compute_dtype", "float16"], None),
    "clip-size": ([], ("data", "clip_height", 100)),
    "channel-order": ([], ("data", "channel_order", "bgr")),
    "decoder": ([], ("data", "decoder", "pyav")),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validate_raises_on_the_same_bad_flags(case):
    argv, override = BAD[case]
    cfgs = [args_to_config(build_parser("ucf101").parse_args(argv), "ucf101"),
            j_args_to_config(j_build_parser("ucf101").parse_args(argv), "ucf101")]
    messages = []
    for cfg, err in zip(cfgs, (port_config.ConfigError, jax_config.ConfigError)):
        if override:
            setattr(getattr(cfg, override[0]), override[1], override[2])
        with pytest.raises(err) as info:
            cfg.validate()
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    assert issubclass(port_config.ConfigError, ValueError)


def test_validate_refuses_a_routing_count_it_would_ignore():
    """The port keeps `routing_iters` for parity and refuses any value but
    the 3 iterations CapsNet runs; the JAX package reads the field nowhere."""
    cfg = args_to_config(build_parser("ucf101").parse_args([]), "ucf101")
    cfg.validate()
    cfg.model.routing_iters = 2
    with pytest.raises(port_config.ConfigError, match="routing_iters"):
        cfg.validate()


def test_validate_passes_the_reference_run_commands():
    for dataset in ("ucf101", "jhmdb"):
        args_to_config(build_parser(dataset).parse_args(NON_DEFAULT), dataset).validate()


EPOCHS = np.concatenate([np.arange(-2, 30, 0.5), [0.0, 1e-9, 4.999999, 5.0, 100.0]])
SCHEDULES = {
    "exp_rampup": (5,),
    "linear_rampup": (7,),
    "pseudo_rampup": (3, 11),
    "exp_rampdown": (4, 20),
    "cosine_rampdown": (6, 25),
    "exp_warmup": (5, 4, 20),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_ramp_schedules_match_jax(name):
    args = SCHEDULES[name]
    port, ref = getattr(port_ramps, name)(*args), getattr(jax_ramps, name)(*args)
    got = [port(float(e)) for e in EPOCHS]
    assert got == [ref(float(e)) for e in EPOCHS]  # the same float arithmetic
    assert all(np.isfinite(got))


def test_multi_process_flag_raises():
    """--num_processes > 1 needs a --coordinator and a --process_id in
    range; one process on one rank joins no process group."""
    args = build_parser("ucf101").parse_args(["--num_processes", "2", "--process_id", "0"])
    with pytest.raises(ValueError, match="coordinator"):
        maybe_initialize_distributed(args)
    args = build_parser("ucf101").parse_args(
        ["--num_processes", "2", "--process_id", "2", "--coordinator", "localhost:1"])
    with pytest.raises(ValueError, match="process_id"):
        maybe_initialize_distributed(args)
    assert not maybe_initialize_distributed(
        build_parser("ucf101").parse_args(["--num_processes", "1"]))


def test_multi_device_flags_raise(tmp_path):
    """The data-parallel flags' gates: a Trainer is one rank (several
    ranks come from the launcher), a host batch must give each rank an
    even count, and --eval_dp cannot exceed the visible devices."""
    from picad_tpu_torch.cli import evaluate_jhmdb, evaluate_ucf101, train_ucf101
    from picad_tpu_torch.train.loop import Trainer

    argv = ["--synthetic", "--bs", "2", "--num_devices", "2", "--save_root", str(tmp_path)]
    cfg = args_to_config(build_parser("ucf101").parse_args(argv), "ucf101")
    with pytest.raises(ValueError, match="one rank"):
        Trainer(cfg, labeled_dataset=None, unlabeled_dataset=None, device="cpu")
    with pytest.raises(ValueError, match="even count"):
        train_ucf101.main(argv, device="cpu")
    for cli in (evaluate_ucf101, evaluate_jhmdb):
        with pytest.raises(ValueError, match="visible devices"):
            cli.main(["--ckpt", str(tmp_path), "--synthetic", "--eval_dp", "2"], device="cpu")
