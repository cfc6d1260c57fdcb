"""``python -m dadiff_tpu_torch.quality_run`` on the CPU: the locomotion
recipes pinned against scripts/r5_phase3.sh, and the PointMaze cells'
wiring (``--cells``, ``--checkpoint``, ``--train-seed``, ``--slim-out``,
TF32 off in the A/B cells) with the trainer, the distiller and the
evaluator replaced by recorders, since the real run needs a card.
"""

import os
import shlex
from pathlib import Path

import pytest
import torch

from dadiff_tpu_torch import cli, eval_ondevice, quality_run as qr
from dadiff_tpu_torch.io.torch_compat import (
    load_pt_checkpoint,
    save_pt_checkpoint,
    slim_pt_checkpoint,
)
from dadiff_tpu_torch.models.diffusion import GaussianDiffusion
from dadiff_tpu_torch.models.temporal_unet import TemporalUnet

# tiny models: one thread, so that test processes side by side do not
# oversubscribe the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _script_commands(suite: str):
    """scripts/r5_phase3.sh's train.py and eval_ondevice_locomotion.py
    commands for ``suite`` ($N, $ENV and $DATA filled in), as argv lists
    without the script name."""
    text = (ROOT / "scripts" / "r5_phase3.sh").read_text()
    text = text.replace("\\\n", " ")
    env = qr.LOCOMOTION[suite][0]
    subs = {"${N}": suite, "$ENV": env, "$DATA": qr.loco_data(suite),
            '"$CKPT"': "CKPT", "$RUN": qr.LOCOMOTION[suite][1]}
    out = {}
    for script in ("train.py", "eval_ondevice_locomotion.py"):
        (line,) = [ln for ln in text.splitlines()
                   if f"scripts/{script}" in ln]
        for k, v in subs.items():
            line = line.replace(k, v)
        argv = shlex.split(line)
        out[script] = argv[argv.index(f"scripts/{script}") + 1:]
    return out


def _pairs(argv):
    """{flag: tuple of its values} of an argv list."""
    flags, key = {}, None
    for a in argv:
        if a.startswith("--"):
            key = a
            flags[key] = ()
        else:
            flags[key] += (a,)
    return flags


@pytest.mark.parametrize("suite", ["hopper", "walker2d"])
def test_locomotion_recipe_matches_r5_phase3(suite):
    """The recipe and the protocol of ``--suite hopper|walker2d`` are the
    script's own flags for that env (its log dir, run name and checkpoint
    apart)."""
    cmds = _script_commands(suite)
    train = _pairs(cmds["train.py"])
    for flag in ("--log-dir", "--run-name", "--seed"):
        train.pop(flag)
    assert _pairs(qr.loco_recipe(suite)) == train
    assert cmds["train.py"][cmds["train.py"].index("--seed") + 1] == "42"
    evaluate = _pairs(cmds["eval_ondevice_locomotion.py"])
    evaluate.pop("--checkpoint")
    assert _pairs(qr.loco_protocol(suite)) == evaluate
    args = qr.build_parser().parse_args(["--suite", suite])
    assert args.train_seed == 42


def test_default_cells_are_the_published_ones():
    args = qr.build_parser().parse_args([])
    assert args.cells == list(qr.CELLS)
    assert not set(args.cells) & set(qr.AB_CELLS)
    for name, (_, flags, _) in (qr.CELLS | qr.AB_CELLS).items():
        # only the protocol cells run the planner chain, their *_module
        # copies the module path
        assert ("--megakernel" in flags) == (
            name in ("projection_bo8", "no_projection_bo8", "projection_bo1",
                     "projection_bo8_ema")), name
        if name in qr.AB_CELLS:
            base = name.replace("_module", "").replace("_f32", "")
            want = [f for f in qr.CELLS[base][1] if f != "--megakernel"]
            assert flags == want, name


def _tiny_pt(path):
    diff = GaussianDiffusion(TemporalUnet(transition_dim=8, dim=8,
                                          dim_mults=(1, 2)),
                             horizon=8, observation_dim=6, action_dim=2,
                             n_timesteps=5)
    ema = {n: p.detach() + 1.0 for n, p in diff.named_parameters()}
    save_pt_checkpoint(str(path), diff, {
        "horizon": 8, "observation_dim": 6, "action_dim": 2,
        "n_timesteps": 5, "beta_schedule": "cosine"}, ema_params=ema)


@pytest.fixture
def recorded(monkeypatch, tmp_path):
    """quality_run's helpers replaced by recorders: train_main and
    distill_main write a tiny .pt, eval_ondevice.main records its argv and
    the TF32 flags it saw."""
    calls = {"train": [], "distill": [], "eval": []}

    def fake_train(argv):
        calls["train"].append(argv)
        d = tmp_path / "train" / argv[argv.index("--run-name") + 1]
        d.mkdir(parents=True)
        _tiny_pt(d / "checkpoint_step_7.pt")
        (d / "metrics.jsonl").write_text('{"step": 7, "total": 1.0}\n')
        return str(d)

    def fake_distill(argv):
        calls["distill"].append(argv)
        d = tmp_path / "distill"
        d.mkdir()
        _tiny_pt(d / "checkpoint_step_3.pt")
        (d / "metrics.jsonl").write_text('{"step": 3, "consistency": 2}\n')
        return str(d)

    def fake_eval(argv):
        calls["eval"].append((argv, torch.backends.cudnn.allow_tf32,
                              torch.backends.cuda.matmul.allow_tf32))
        return {k: 0.5 for k in qr.CELL_KEYS} | {
            "model_calls_per_replan": [1, 1]}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(qr, "card_line", lambda: "card, 700.00 W")
    monkeypatch.setattr(qr.os, "chdir", lambda _: None)
    monkeypatch.setattr(cli, "train_main", fake_train)
    monkeypatch.setattr(cli, "distill_main", fake_distill)
    monkeypatch.setattr(eval_ondevice, "main", fake_eval)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return calls


def test_cells_train_seed_and_slim_out(recorded, tmp_path):
    """A run of two cells at train seed 7: one training at that seed, one
    distillation, each cell at the four seeds on its checkpoint, TF32 off
    only inside the A/B cell and restored after, and slim copies of both
    checkpoints that load in the port."""
    slim = tmp_path / "slim"
    summary = qr.main(["--cells", "projection_bo1", "student_1call_f32",
                       "--train-seed", "7", "--slim-out", str(slim),
                       "--out", str(tmp_path / "out")])
    (train,) = recorded["train"]
    assert train[train.index("--seed") + 1] == "7"
    assert train[train.index("--run-name") + 1] == "flagship_seed7"
    (distill,) = recorded["distill"]
    assert distill[distill.index("--seed") + 1] == "7"
    assert len(recorded["eval"]) == 8
    for argv, cudnn, matmul in recorded["eval"]:
        ckpt = argv[argv.index("--checkpoint") + 1]
        if "consistency" in argv:
            assert ckpt.endswith("checkpoint_step_3.pt")
            assert (cudnn, matmul) == (False, False)
        else:
            assert ckpt.endswith("checkpoint_step_7.pt")
            assert "--megakernel" in argv and (cudnn, matmul) == (True, False)
    assert torch.backends.cudnn.allow_tf32 is True
    assert sorted(summary["cells"]) == sorted(
        f"{c}_seed{s}" for c in ("projection_bo1", "student_1call_f32")
        for s in qr.SEEDS)
    assert summary["cells"]["student_1call_f32_seed42"]["tf32"] == {
        "cudnn": False, "matmul": False}
    for name in ("teacher_seed7.pt", "student_seed7.pt"):
        got = load_pt_checkpoint(str(slim / name))
        assert "ema_state_dict" not in got and got["model_state_dict"]


def test_checkpoint_skips_training(recorded, tmp_path):
    """``--checkpoint`` evaluates the file given: no training, no
    distillation without a student cell, nothing slimmed."""
    ckpt = tmp_path / "given.pt"
    _tiny_pt(ckpt)
    qr.main(["--cells", "no_projection_bo8_module", "--checkpoint",
             str(ckpt), "--slim-out", str(tmp_path / "slim"), "--out",
             str(tmp_path / "out")])
    assert recorded["train"] == [] and recorded["distill"] == []
    assert {a[a.index("--checkpoint") + 1] for a, _, _ in recorded["eval"]} \
        == {str(ckpt)}
    assert all("--megakernel" not in a and not cudnn
               for a, cudnn, _ in recorded["eval"])
    assert not os.path.exists(tmp_path / "slim")


def test_slim_checkpoint_keeps_the_model_weights(tmp_path):
    src, dst = tmp_path / "full.pt", tmp_path / "sub" / "slim.pt"
    _tiny_pt(src)
    slim_pt_checkpoint(str(src), str(dst))
    full, slim = load_pt_checkpoint(str(src)), load_pt_checkpoint(str(dst))
    assert "ema_state_dict" in full and "ema_state_dict" not in slim
    assert slim["config"] == full["config"]
    assert slim["model_state_dict"].keys() == full["model_state_dict"].keys()
    for k, v in full["model_state_dict"].items():
        assert torch.equal(slim["model_state_dict"][k], v), k
    assert os.path.getsize(dst) < 0.6 * os.path.getsize(src)
