"""QuantizedTrainer: the learner as a queue of minibatch-sized pieces.

Counterpart of `sample_factory_tpu/algo/quantized_train.py`. One stream of a
device runs what it is given in order, so a whole train call issued at once
would sit in front of the next rollout's first inference step (and with it
every CPU env worker) for its full duration. Instead the train step is cut into

    prepare -> (num_epochs x num_minibatches) sgd quanta -> per-epoch lr

and the host dispatches quanta right after each env step's actions are shipped
to the CPU workers (the `idle_fn` hook of `HostVectorSampler.collect_rollout`),
so that training runs while the workers step. This is the overlap the reference
gets from separate learner and inference processes (reference
`algo/sampling/inference_worker.py:349-368`, `algo/learning/batcher.py:170-218`).

Semantics are those of the fused train call (`learning.make_train_fn`), piece by
piece and draw by draw: contiguous minibatches are views made once; with
--shuffle_minibatches a per-epoch quantum draws the segment permutation from the
same generator; epochs 0 and 1 always run and epoch e >= 2 runs only if the two
previous epoch-mean policy losses differ by more than 1e-6 (reference
learner.py:676,827-837), which the host reads one quantum after they were
computed; the summary stats are those of a random minibatch of the last executed
epoch. The live module and optimizer are updated in place, one `train_step` per
sgd quantum, so a rollout that runs between two quanta must run a snapshot of
the parameters (`runner/host_runner.py`), under `torch.no_grad()`; a quantum
keeps no autograd graph once it returns.

Host syncs: `prepare` reads the valid fraction (it scales the learning rate, as in
the fused call) and each early-stop check reads two loss scalars.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

import torch

from sample_factory_tpu_torch.algo.learning import (
    EARLY_STOPPING_TOLERANCE,
    PolicyTrainState,
    _tree_map,
    build_train_pieces,
)
from sample_factory_tpu_torch.algo.schedules import lr_after_epoch


class QuantizedTrainer:
    early_stopping_tolerance = EARLY_STOPPING_TOLERANCE

    def __init__(self, cfg, env_info, policy_id: int = 0, num_envs: Optional[int] = None):
        self.cfg = cfg
        self.policy_id = policy_id
        self._sgd_step, self._prepare_batch = build_train_pieces(cfg, env_info, policy_id)

        n = num_envs if num_envs is not None else cfg.num_envs
        dataset_size = n * cfg.rollout
        self.batch_size = min(cfg.batch_size, dataset_size)
        self.num_minibatches = dataset_size // self.batch_size
        self.num_epochs = cfg.num_epochs
        self.shuffle = bool(cfg.shuffle_minibatches)
        self.recurrence = max(1, cfg.recurrence)
        self.num_segments = dataset_size // self.recurrence
        self.segs_per_mb = self.batch_size // self.recurrence
        # train_step advances one per sgd quantum: the runner mirrors the policy version on
        # the host from this count alone (early-stop skips are corrected at flush through
        # last_skipped_sgd_steps)
        self.sgd_steps_per_train = self.num_minibatches * self.num_epochs
        self.last_sgd_steps_executed = self.sgd_steps_per_train
        self.last_skipped_sgd_steps = 0

        self._thunks: deque = deque()
        self._state: Dict[str, Any] = {}
        # dispatch accounting: quanta dispatched during rollouts (via idle_fn) against those
        # drained at flush(): an overlap signal that does not depend on the machine's load
        self.total_quanta_enqueued = 0
        self.quanta_drained_at_flush = 0

    @property
    def pending(self) -> int:
        return len(self._thunks)

    def _contiguous_minibatches(self, dataset):
        B = self.batch_size
        return [_tree_map(lambda x: x[i * B : (i + 1) * B], dataset) for i in range(self.num_minibatches)]

    def _shuffled_minibatches(self, dataset, generator):
        """Segment-level permutation gather, the fused call's (`learning.py`, epoch_minibatches)."""
        S, R, B, per_mb = self.num_segments, self.recurrence, self.batch_size, self.segs_per_mb
        device = dataset["valids"].device
        perm = torch.randperm(S, generator=generator, device=device)[: self.num_minibatches * per_mb]

        def gather(x, sel):
            return x.reshape((S, R) + tuple(x.shape[1:]))[sel].reshape((B,) + tuple(x.shape[1:]))

        return [_tree_map(lambda x: gather(x, perm[i * per_mb : (i + 1) * per_mb]), dataset) for i in range(self.num_minibatches)]

    def enqueue(self, ts: PolicyTrainState, traj: Dict[str, Any], generator: Optional[torch.Generator] = None) -> None:
        """Queue the train step for `traj` as dispatchable quanta. The caller must flush() the
        previous train step first (one in flight at a time: the analog of
        --num_batches_to_accumulate=2 backpressure). `generator` draws what the fused call
        draws from it: the shuffles and the summary minibatch."""
        assert not self._thunks, "flush() the previous train step before enqueue()"
        M, E = self.num_minibatches, self.num_epochs
        st = self._state = {
            "ts": ts, "traj": traj, "generator": generator, "dataset": None, "mbs": None, "vf": None,
            "epoch_aux": None, "epoch_losses": [], "sgd_executed": 0, "epochs_executed": 0,
        }

        def q_prepare():
            st["dataset"], st["vf"] = self._prepare_batch(ts, traj, self.policy_id)
            if not self.shuffle:
                # the minibatch layout does not change with the epoch: views, made once
                st["mbs"] = self._contiguous_minibatches(st["dataset"])

        self._thunks.append(q_prepare)
        for e in range(E):
            if e >= 2:
                # early-stop gate: the loss scalars were computed a quantum ago (end of epoch
                # e-1), so this read normally finds them ready
                def q_check():
                    l_prev2, l_prev1 = (float(x) for x in st["epoch_losses"][-2:])
                    if abs(l_prev2 - l_prev1) < self.early_stopping_tolerance:
                        self._thunks.clear()  # drop this train step's remaining quanta

                self._thunks.append(q_check)
            if self.shuffle:
                def q_shuffle():
                    st["mbs"] = self._shuffled_minibatches(st["dataset"], generator)

                self._thunks.append(q_shuffle)

            epoch_aux: list = []
            for m in range(M):
                def q_sgd(m=m, epoch_aux=epoch_aux):
                    epoch_aux.append(self._sgd_step(ts, st["vf"], st["mbs"][m]))
                    st["sgd_executed"] += 1

                self._thunks.append(q_sgd)

            def q_lr(epoch_aux=epoch_aux):
                aux_seq = {k: torch.stack([a[k] for a in epoch_aux]) for k in epoch_aux[0]}
                ts.curr_lr = lr_after_epoch(self.cfg, ts.curr_lr, aux_seq["kl_divergence"].mean())
                st["epoch_aux"] = aux_seq
                st["epoch_losses"].append(aux_seq["policy_loss"].mean())
                st["epochs_executed"] += 1

            self._thunks.append(q_lr)
        # the assert above guarantees the queue was empty at entry, so every thunk in it was
        # added by this call
        self.total_quanta_enqueued += len(self._thunks)

    def dispatch_one(self) -> bool:
        """Dispatch the next quantum. Returns True while more quanta remain. This is what
        the sampler's idle_fn calls."""
        if self._thunks:
            self._thunks.popleft()()
        return bool(self._thunks)

    def flush(self) -> Dict[str, torch.Tensor]:
        """Dispatch any remaining quanta and return the train step's stats (device tensors,
        the fused call's keys). The train state given to enqueue() was updated in place."""
        self.quanta_drained_at_flush += len(self._thunks)
        while self._thunks:
            self.dispatch_one()
        st = self._state
        ts, traj = st["ts"], st["traj"]
        self.last_sgd_steps_executed = st["sgd_executed"]
        self.last_skipped_sgd_steps = self.sgd_steps_per_train - st["sgd_executed"]
        device = st["dataset"]["valids"].device
        # summaries from a random minibatch of the last executed epoch (reference learner.py:693-703)
        mb_idx = torch.randint(0, self.num_minibatches, (), generator=st["generator"], device=device)
        stats = {k: v[mb_idx] for k, v in st["epoch_aux"].items()}
        stats["epochs_executed"] = torch.full((), float(st["epochs_executed"]), device=device)
        stats["valids_fraction"] = torch.full((), st["vf"], device=device)
        stats["lr"] = torch.full((), ts.curr_lr, device=device)
        stats["version_diff_max"] = (ts.train_step - traj["policy_version"]).max().float()
        self._state = {}  # let go of the trajectory and the dataset
        return stats
