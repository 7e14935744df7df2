"""HuggingFace Hub integration: push and pull experiment directories, model cards, replay videos.

Counterpart of `sample_factory_tpu/hub/huggingface_hub_utils.py` (reference
`sample_factory/huggingface/huggingface_utils.py`: generate_model_card, push_to_hf,
load_from_hub). `huggingface_hub` and `cv2` are imported inside the functions, so
that the package imports on a machine that has neither.

The card names commands that exist in the port: its `enjoy` and `train_gym_env`
modules, and `load_from_hf` called through `python -c`. (The JAX card names a
`sample_factory_tpu.hub.load_from_hub` module that does not exist.)
"""

from __future__ import annotations

from os.path import join
from typing import List, Optional

from sample_factory_tpu_torch.utils.utils import log

ENJOY_MODULE = "sample_factory_tpu_torch.enjoy"
TRAIN_MODULE = "sample_factory_tpu_torch.examples.train_gym_env"


def hf_available() -> bool:
    try:
        import huggingface_hub  # noqa: F401

        return True
    except ImportError:
        return False


def generate_model_card(
    dir_path: str,
    algo: str,
    env: str,
    repo_id: str,
    rewards: Optional[List[float]] = None,
    enjoy_name: str = ENJOY_MODULE,
    train_name: str = TRAIN_MODULE,
) -> None:
    """Write `README.md` into `dir_path`: the mean and std of `rewards` as a model-index entry,
    and the commands that download, play back and resume the model."""
    readme_path = join(dir_path, "README.md")
    repo_name = repo_id.split("/")[-1]

    metrics = ""
    if rewards:
        import numpy as np

        mean, std = float(np.mean(rewards)), float(np.std(rewards))
        metrics = (
            "model-index:\n"
            f"- name: {algo}\n"
            "  results:\n"
            "  - task:\n      type: reinforcement-learning\n      name: reinforcement-learning\n"
            f"    dataset:\n      name: {env}\n      type: {env}\n"
            "    metrics:\n    - type: mean_reward\n"
            f"      value: {mean:.2f} +/- {std:.2f}\n      name: mean_reward\n      verified: false\n"
        )

    readme = f"""---
library_name: sample-factory-tpu
tags:
- deep-reinforcement-learning
- reinforcement-learning
- sample-factory-tpu
{metrics}---

A(n) **{algo}** model trained on the **{env}** environment.

This model was trained using the PyTorch package of sample-factory-tpu, a rebuild of
Sample Factory.

## Downloading the model

```
python -c "from sample_factory_tpu_torch.hub.huggingface_hub_utils import load_from_hf; load_from_hf('train_dir', '{repo_id}')"
```

## Using the model

```
python -m {enjoy_name} --algo={algo} --env={env} --train_dir=./train_dir --experiment={repo_name}
```

## Training with this model

```
python -m {train_name} --algo={algo} --env={env} --train_dir=./train_dir --experiment={repo_name} --restart_behavior=resume --train_for_env_steps=10000000000
```
"""
    with open(readme_path, "w") as f:
        f.write(readme)


def generate_replay_video(dir_path: str, frames: List, fps: int, cfg) -> str:
    """Write the replay (`--video_name`, default replay.mp4) from HWC uint8 RGB frames."""
    import cv2
    import numpy as np

    video_name = cfg.video_name or "replay.mp4"
    if not video_name.endswith(".mp4"):
        video_name += ".mp4"
    video_path = join(dir_path, video_name)
    if not frames:
        log.warning("No frames to write")
        return video_path
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"), max(1, fps), (w, h))
    try:
        for frame in frames:
            writer.write(cv2.cvtColor(np.asarray(frame), cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
    log.info("Replay video saved to %s", video_path)
    return video_path


def push_to_hf(dir_path: str, repo_name: str) -> None:
    if not hf_available():
        log.error("huggingface_hub is not installed")
        return
    from huggingface_hub import HfApi

    api = HfApi()
    repo_url = api.create_repo(repo_id=repo_name, private=False, exist_ok=True)
    api.upload_folder(repo_id=repo_name, folder_path=dir_path, path_in_repo=".")
    log.info("Experiment folder %s pushed to %s", dir_path, repo_url)


def load_from_hf(dir_path: str, repo_id: str) -> str:
    """Download `repo_id` into `<dir_path>/<repo name>`, the experiment directory layout."""
    if not hf_available():
        raise RuntimeError("huggingface_hub is not installed")
    from huggingface_hub import snapshot_download

    out = join(dir_path, repo_id.split("/")[-1])
    snapshot_download(repo_id=repo_id, local_dir=out)
    log.info("Model downloaded to %s", out)
    return out
