"""The port's tooling on the CPU: the launcher, W&B, TensorBoard event files, the Hub model card,
the replay video and the Hub transfers.

- the six cases of `tests/test_launcher.py` through the port's copy of the launcher;
- `--with_wandb=True` with a stand-in `wandb` module: `init` with a run id that two fresh
  interpreters compute alike (the JAX package takes `hash()` of the path, salted per
  interpreter), every scalar logged at `step=env_steps`, `finish` at the end of the run;
- TensorBoard event files beside the JSONL summaries where tensorboardX imports;
- the model card's text, whose commands name modules that exist in the port;
- `enjoy --save_video --push_to_hub` on a small `rgb_array` env: the `.mp4` read back frame by
  frame, the card and the push against a stubbed `HfApi`; `load_from_hf` against a stubbed
  `snapshot_download`.
Nothing here reaches the network: `wandb` is not installed here, and the Hub calls are stubbed.
"""

import argparse
import glob
import importlib.util
import json
import os
import struct
import subprocess
import sys
import types
from os.path import join

import numpy as np
import pytest
import torch

from sample_factory_tpu_torch.algo.context import reset_global_context
from sample_factory_tpu_torch.launcher.run_description import Experiment, ParamGrid, ParamList, RunDescription

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_context():
    reset_global_context()
    yield
    reset_global_context()


# ----------------------------------------------------------------------- launcher


def test_param_grid():
    grid = ParamGrid([("a", [1, 2]), ("b", ["x", "y"])])
    assert list(grid.generate_params(randomize=False)) == [
        {"a": 1, "b": "x"}, {"a": 1, "b": "y"}, {"a": 2, "b": "x"}, {"a": 2, "b": "y"},
    ]


def test_param_grid_coupled_params():
    grid = ParamGrid([(("lr", "bs"), [(1e-3, 32), (1e-4, 64)])])
    assert list(grid.generate_params(randomize=False)) == [{"lr": 1e-3, "bs": 32}, {"lr": 1e-4, "bs": 64}]


def test_param_list():
    pl = ParamList([{"seed": 0}, {"seed": 1}])
    assert list(pl.generate_params(randomize=False)) == [{"seed": 0}, {"seed": 1}]


def test_run_description_generates_commands(tmp_path):
    grid = ParamGrid([("seed", [0, 1]), ("learning_rate", [1e-3])])
    cmd_base = "python -m sample_factory_tpu_torch.examples.train_synthetic --env=synthetic_vector_discrete"
    rd = RunDescription("my_run", [Experiment("test_exp", cmd_base, grid.generate_params(randomize=False))])
    cmds = list(rd.generate_experiments(str(tmp_path)))
    assert len(cmds) == 2
    cmd, name, root_dir, env_vars = cmds[0]
    assert "--seed=0" in cmd and "--learning_rate=0.001" in cmd
    assert "--experiment=test_exp_seed_0_learning_rate_0.001" in cmd
    assert f"--train_dir={tmp_path}/my_run/test_exp" in cmd
    assert (tmp_path / "my_run" / "test_exp").is_dir()


def test_list_param_formatting(tmp_path):
    grid = ParamGrid([("encoder_mlp_layers", [[64, 64], [128]])])
    rd = RunDescription("r", [Experiment("e", "train", grid.generate_params(randomize=False))], customize_experiment_name=False)
    cmds = [c for c, *_ in rd.generate_experiments(str(tmp_path), makedirs=False)]
    assert "--encoder_mlp_layers=64 64" in cmds[0]
    assert "--encoder_mlp_layers=128" in cmds[1]


def test_ngc_backend_templating(tmp_path):
    """The NGC backend renders {{ name }}/{{ experiment_cmd }} into the job template, print-only."""
    from sample_factory_tpu_torch.launcher.run_ngc import render_job_command, run_ngc

    template = tmp_path / "job.template"
    template.write_text("ngc batch run --name {{ name }} \\\n  --image foo:latest \\\n  --commandline \"{{ experiment_cmd }}\"\n")
    rendered = render_job_command(template.read_text(), "jobname", "python train.py --x=1")
    assert rendered == 'ngc batch run --name jobname --image foo:latest --commandline "python train.py --x=1"'

    rd = RunDescription("ngc_run", [Experiment("ngc_exp", "python -m train", ParamGrid([("seed", [0, 1])]).generate_params(randomize=False))])
    args = argparse.Namespace(train_dir=str(tmp_path), ngc_job_template=str(template), ngc_print_only=True, pause_between=0)
    assert run_ngc(rd, args) == 0
    args.ngc_job_template = None  # missing template: an error
    assert run_ngc(rd, args) == 1


def test_process_backend_gives_each_experiment_a_card(tmp_path):
    """The local-process backend runs every experiment of the grid, each with its log file and
    the least busy of --num_devices cards in CUDA_VISIBLE_DEVICES."""
    from sample_factory_tpu_torch.launcher.run_processes import run

    script = tmp_path / "show_card.py"
    script.write_text("import os, sys\nprint(os.environ['CUDA_VISIBLE_DEVICES'], sys.argv[1:])\n")
    rd = RunDescription("procs", [Experiment("e", f"{sys.executable} {script}", ParamGrid([("seed", [0, 1])]).generate_params(randomize=False))])
    args = argparse.Namespace(train_dir=str(tmp_path), max_parallel=2, experiments_per_device=1, num_devices=2)
    assert run(rd, args) == 0
    logs = sorted((tmp_path / f"e_seed_{seed}.log").read_text().split()[0] for seed in (0, 1))
    assert logs == ["0", "1"]


# ------------------------------------------------------------------- wandb, events


class _FakeRun:
    def __init__(self):
        self.logged = []
        self.finished = False

    def log(self, data, step=None):
        self.logged.append((dict(data), step))

    def finish(self):
        self.finished = True


def _fake_wandb():
    fake = types.ModuleType("wandb")
    fake.run, fake.inits, fake.config_updates = None, [], []

    def init(**kwargs):
        fake.inits.append(kwargs)
        fake.run = _FakeRun()
        return fake.run

    fake.init = init
    fake.Settings = lambda **kwargs: kwargs
    fake.config = types.SimpleNamespace(update=lambda d, allow_val_change=False: fake.config_updates.append(dict(d)))
    return fake


def _read_events(path):
    """The scalar records of a TensorBoard event file: {tag: [(step, value)]}."""
    from tensorboardX.proto import event_pb2

    scalars = {}
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack("<Q", data[pos : pos + 8])
        event = event_pb2.Event.FromString(data[pos + 12 : pos + 12 + length])
        pos += 12 + length + 4  # length, its crc, the record, its crc
        for v in event.summary.value:
            scalars.setdefault(v.tag, []).append((event.step, v.simple_value))
    return scalars


def _run_id_in_fresh_interpreter(train_dir, hash_seed):
    code = ("from sample_factory_tpu_torch.cfg.arguments import default_cfg\n"
            "from sample_factory_tpu_torch.utils.wandb_utils import wandb_run_id\n"
            f"print(wandb_run_id(default_cfg(env='grid_battle', experiment='wb', argv=['--train_dir={train_dir}'])))\n")
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED=str(hash_seed))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_wandb_run_and_event_files(tmp_path, monkeypatch):
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args, register_synthetic_components
    from sample_factory_tpu_torch.train import run_rl

    fake = _fake_wandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    register_synthetic_components()
    argv = ["--env=grid_battle", "--experiment=wb", f"--train_dir={tmp_path}", "--device=cpu", "--async_rl=False", "--num_envs=8",
            "--rollout=8", "--batch_size=32", "--use_rnn=False", "--encoder_conv_architecture=convnet_impala",
            "--encoder_conv_mlp_layers", "16", "--train_for_env_steps=192", "--experiment_summaries_interval=0", "--seed=1",
            "--with_wandb=True", "--wandb_project=p", "--wandb_tags", "a", "b"]
    assert run_rl(parse_custom_args(argv)) == 0

    (kwargs,) = fake.inits
    run_id = kwargs["id"]
    assert run_id == _run_id_in_fresh_interpreter(tmp_path, 1) == _run_id_in_fresh_interpreter(tmp_path, 2)
    assert run_id.startswith("wb_") and kwargs["resume"] == "allow" and kwargs["project"] == "p" and kwargs["tags"] == ["a", "b"]
    assert fake.config_updates[0]["env"] == "grid_battle"
    steps = [step for _, step in fake.run.logged]
    assert steps == sorted(steps) and steps[-1] == 192
    assert all("train/loss" in data and np.isfinite(data["train/loss"]) for data, _ in fake.run.logged)
    assert fake.run.finished

    # the JSONL record and, beside it, the same scalars as TensorBoard events
    summaries = tmp_path / "wb" / ".summary" / "0"
    with open(summaries / "summaries.jsonl") as f:
        records = [json.loads(line) for line in f]
    (events_file,) = glob.glob(str(summaries / "events.out.tfevents.*"))
    events = _read_events(events_file)
    jsonl_loss = [(r["env_steps"], r["train/loss"]) for r in records if "train/loss" in r]
    assert len(jsonl_loss) == len(fake.run.logged) >= 2
    assert [s for s, _ in events["train/loss"]] == [s for s, _ in jsonl_loss]
    np.testing.assert_allclose([v for _, v in events["train/loss"]], [v for _, v in jsonl_loss], rtol=1e-6)


# ---------------------------------------------------------------- hub and video


def test_model_card_names_commands_of_the_port(tmp_path):
    from sample_factory_tpu_torch.hub.huggingface_hub_utils import ENJOY_MODULE, TRAIN_MODULE, generate_model_card

    generate_model_card(str(tmp_path), "APPO", "CartPole-v1", "someone/cartpole-appo", rewards=[1.0, 2.0, 3.0])
    card = (tmp_path / "README.md").read_text()
    assert card.startswith("---\nlibrary_name: sample-factory-tpu\n")
    assert "- name: APPO\n" in card and "      name: CartPole-v1\n" in card and "      value: 2.00 +/- 0.82\n" in card
    assert "load_from_hf('train_dir', 'someone/cartpole-appo')" in card and "load_from_hub" not in card
    assert f"python -m {ENJOY_MODULE} --algo=APPO --env=CartPole-v1 --train_dir=./train_dir --experiment=cartpole-appo" in card
    assert f"python -m {TRAIN_MODULE} --algo=APPO --env=CartPole-v1" in card
    for module in (ENJOY_MODULE, TRAIN_MODULE, "sample_factory_tpu_torch.hub.huggingface_hub_utils"):
        assert importlib.util.find_spec(module) is not None, module

    generate_model_card(str(tmp_path), "APPO", "CartPole-v1", "someone/cartpole-appo")  # no rewards: no model index
    assert "model-index" not in (tmp_path / "README.md").read_text()


class _FakeHfApi:
    calls = []

    def create_repo(self, repo_id, private, exist_ok):
        self.calls.append(("create_repo", repo_id, private, exist_ok))
        return f"https://hub.invalid/{repo_id}"

    def upload_folder(self, repo_id, folder_path, path_in_repo):
        self.calls.append(("upload_folder", repo_id, sorted(os.listdir(folder_path)), path_in_repo))


def test_push_and_load_against_a_stubbed_hub(tmp_path, monkeypatch):
    import huggingface_hub

    from sample_factory_tpu_torch.hub.huggingface_hub_utils import load_from_hf, push_to_hf

    monkeypatch.setattr(_FakeHfApi, "calls", [])
    monkeypatch.setattr(huggingface_hub, "HfApi", _FakeHfApi)
    (tmp_path / "exp").mkdir()
    (tmp_path / "exp" / "config.json").write_text("{}")
    push_to_hf(str(tmp_path / "exp"), "someone/exp")
    assert _FakeHfApi.calls == [("create_repo", "someone/exp", False, True), ("upload_folder", "someone/exp", ["config.json"], ".")]

    downloads = []

    def snapshot_download(repo_id, local_dir):
        downloads.append((repo_id, local_dir))
        os.makedirs(local_dir, exist_ok=True)
        with open(join(local_dir, "config.json"), "w") as f:
            f.write("{}")
        return local_dir

    monkeypatch.setattr(huggingface_hub, "snapshot_download", snapshot_download)
    out = load_from_hf(str(tmp_path / "train_dir"), "someone/exp")
    assert out == str(tmp_path / "train_dir" / "exp") and downloads == [("someone/exp", out)]
    assert os.path.isfile(join(out, "config.json"))


FRAME_HW = (32, 48)


def _paint_env_class():
    import gymnasium as gym

    class PaintEnv(gym.Env):
        """An 8-step episodic env whose rgb_array frames encode the step in their red channel."""

        metadata = {"render_modes": ["rgb_array"], "render_fps": 30}

        def __init__(self, render_mode=None):
            self.observation_space = gym.spaces.Box(-1, 1, (4,), np.float32)
            self.action_space = gym.spaces.Discrete(2)
            self.render_mode = render_mode
            self.t = 0

        def reset(self, *, seed=None, options=None):
            super().reset(seed=seed)
            self.t = 0
            return np.zeros(4, np.float32), {}

        def step(self, action):
            self.t += 1
            return np.full(4, self.t / 8, np.float32), 1.0, self.t >= 8, False, {}

        def render(self):
            assert self.render_mode == "rgb_array"
            frame = np.zeros(FRAME_HW + (3,), np.uint8)
            frame[..., 0] = 30 * self.t
            return frame

    return PaintEnv


def register_paint_env():
    from sample_factory_tpu_torch.envs.env_utils import register_env

    cls = _paint_env_class()
    register_env("paint_env", lambda name, cfg=None, env_config=None, render_mode=None: cls(render_mode=render_mode))


def test_enjoy_saves_a_replay_video_and_pushes_to_the_hub(tmp_path, monkeypatch):
    import cv2
    import huggingface_hub

    from sample_factory_tpu_torch.enjoy import enjoy
    from sample_factory_tpu_torch.examples.train_gym_env import parse_gym_args
    from sample_factory_tpu_torch.train import run_rl

    common = ["--env=paint_env", "--experiment=paint", f"--train_dir={tmp_path}", "--device=cpu"]
    register_paint_env()
    assert run_rl(parse_gym_args(common + ["--serial_mode=True", "--num_workers=1", "--num_envs_per_worker=4", "--rollout=8",
                                           "--batch_size=32", "--use_rnn=False", "--train_for_env_steps=64",
                                           "--encoder_mlp_layers", "8"]), register_fn=register_paint_env) == 0

    monkeypatch.setattr(_FakeHfApi, "calls", [])
    monkeypatch.setattr(huggingface_hub, "HfApi", _FakeHfApi)
    episodes = []
    cfg = parse_gym_args(common + ["--save_video", "--video_frames=12", "--max_num_episodes=2", "--push_to_hub",
                                   "--hf_repository=someone/paint"], evaluation=True)
    status, avg_reward = enjoy(cfg, collect_episodes=episodes)
    assert status == 0 and episodes == [(8.0, 8), (8.0, 8)] and avg_reward == 8.0

    video = cv2.VideoCapture(str(tmp_path / "paint" / "replay.mp4"))
    frames = []
    while True:
        ok, frame = video.read()
        if not ok:
            break
        frames.append(frame)
    video.release()
    assert len(frames) == 12 and frames[0].shape == FRAME_HW + (3,)
    # red (BGR channel 2) grows 30 a step through the first episode, then starts again
    red = [int(np.median(f[..., 2])) for f in frames]
    assert all(abs(r - 30 * t) <= 8 for r, t in zip(red, list(range(1, 9)) + list(range(1, 5)))), red

    card = (tmp_path / "paint" / "README.md").read_text()
    assert "      value: 8.00 +/- 0.00\n" in card and "--env=paint_env" in card
    assert _FakeHfApi.calls[0] == ("create_repo", "someone/paint", False, True)
    assert _FakeHfApi.calls[1][0] == "upload_folder" and {"README.md", "replay.mp4", "config.json"} <= set(_FakeHfApi.calls[1][2])
