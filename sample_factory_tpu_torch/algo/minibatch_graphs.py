"""The learner's minibatch as a CUDA graph: the device work of one sgd step up to the optimizer (the forward and the
losses, the in-place `zero_grad`, `loss.backward()`, the gradient norm and the clip) captured once for each model and
replayed for every later minibatch. The optimizer's step, the learning rate and its schedule stay eager, after the
replay (`learning.py:sgd_step`).

Where it engages (`replays_minibatches`): the dataset lies on a CUDA device, one rank (no data-parallel collectives,
no tensor parallelism) and contiguous minibatches, which all have `batch_size` rows. A graph reads its inputs at fixed
addresses: each minibatch is copied into the graph's own input buffers (one minibatch's rows, the segments' initial
recurrent states alone) before its replay, and the statistics it wrote are copied out after it. The dataset is not kept
between train calls for the graph to read in place: held through the next rollout and the normalizer's update, it
would raise the peak of device memory by its whole size. A graph also bakes in every Python number of the losses, so
it is captured again whenever `graph_key` changes: the inputs' shapes and dtypes, the parameters' and gradients'
addresses, `ts.hparams` (PBT), TF32. Anything else runs the eager step.

The first minibatch under a new key runs its step eagerly on a side stream (those gradients and statistics are the
call's own), then captures it, which executes nothing, into a memory pool of the graph's own. A replay adds to
`ops/cuda_rnn.launch_counts()` the RNN kernels its capture launched, and a capture adds nothing: the counts stay the
kernels that ran. While tracing, each capture counts `learner.graph_captures` and each replay `learner.graph_replays`
(`utils/timing.tracer().count`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from sample_factory_tpu_torch.ops import cuda_rnn
from sample_factory_tpu_torch.utils.timing import tracer

Aux = Dict[str, torch.Tensor]
Step = Callable[[Dict], Tuple[Aux, torch.Tensor]]


def replays_minibatches(cfg, device: torch.device, distributed: bool, tp) -> bool:
    """Whether a train call on `device` replays its minibatches as CUDA graphs: a CUDA device, one rank
    (`distributed`: data-parallel collectives), no tensor parallelism (`tp`), contiguous minibatches."""
    return device.type == "cuda" and not distributed and tp is None and not cfg.shuffle_minibatches


def _leaves(tree) -> List[torch.Tensor]:
    return [x for k in sorted(tree) for x in _leaves(tree[k])] if isinstance(tree, dict) else [tree]


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def graph_key(ts, dataset, batch_size: int) -> Tuple:
    """What the graph of `ts.model` bakes in: the shapes of its inputs (`batch_size` rows of each dataset leaf) and
    their dtypes, each parameter's and gradient's address, shape and dtype, the values of `ts.hparams`, and TF32 (every
    parameter has a gradient by then). A graph captured under another key is never replayed."""
    params = list(ts.model.parameters())
    return (
        batch_size,
        tuple((tuple(x.shape[1:]), x.dtype) for x in _leaves(dataset)),
        tuple((p.data_ptr(), p.grad.data_ptr(), tuple(p.shape), p.dtype) for p in params),
        tuple(sorted(ts.hparams.items())),
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
    )


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: Dict  # the buffers each minibatch is copied into
    aux: Aux  # what each replay writes
    grad_norm: torch.Tensor
    launches: Dict[str, int]  # the RNN kernels a replay launches


class MinibatchGraphs:
    """The graphs of one train function: for each model, its key and its graph."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self._models: Dict[int, Tuple[Tuple, Optional[_Graph]]] = {}
        self._stream = None

    def begin(self, ts, key: Tuple) -> None:
        """At the start of a train call: the graph of `ts.model` captured under another key is dropped."""
        held = self._models.get(id(ts.model))
        if held is None or held[0] != key:
            self._models[id(ts.model)] = (key, None)

    def run(self, ts, inputs: Dict, step: Step) -> Tuple[Aux, torch.Tensor]:
        """`step(inputs)`'s statistics and gradient norm, its gradients in the parameters' .grad: by a replay of the
        model's graph on a copy of `inputs`, or, where it has none, by `step(inputs)` itself, then captured."""
        key, held = self._models[id(ts.model)]
        if held is None:
            aux, grad_norm, held = self._capture(inputs, step)
            self._models[id(ts.model)] = (key, held)
            self.captures += 1
            tracer().count("learner.graph_captures")
            return aux, grad_norm
        torch._foreach_copy_(_leaves(held.inputs), _leaves(inputs))
        held.graph.replay()
        cuda_rnn.add_launch_counts(held.launches)
        self.replays += 1
        tracer().count("learner.graph_replays")
        written = [*held.aux.values(), held.grad_norm]
        out = [torch.empty_like(x) for x in written]
        torch._foreach_copy_(out, written)  # the next replay writes over the graph's outputs
        return dict(zip(held.aux, out)), out[-1]

    def _capture(self, inputs: Dict, step: Step):
        """step() on the graph's new input buffers, run eagerly on the side stream, then captured into a new graph
        -> (the eager statistics and gradient norm, the graph)."""
        static = _map(lambda x: torch.empty_like(x, memory_format=torch.contiguous_format), inputs)
        torch._foreach_copy_(_leaves(static), _leaves(inputs))
        device = _leaves(static)[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        stream, current = self._stream, torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            # eager first: every lazy initialisation (cuBLAS workspaces of this stream, the kernels' attributes and
            # occupancy checks) happens outside the capture
            aux, grad_norm = step(static)
            before = cuda_rnn.launch_counts()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin()
            try:
                static_aux, static_norm = step(static)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is invalidated; the step's own error is the one to report
                raise
            graph.capture_end()
            after = cuda_rnn.launch_counts()
        cuda_rnn.reset_launch_counts()
        cuda_rnn.add_launch_counts(before)  # the capture launched nothing
        current.wait_stream(stream)
        for t in (*aux.values(), grad_norm):
            t.record_stream(current)
        # the eager step's blocks cached for the side stream go back to the card: nothing but a capture runs there
        torch.cuda.empty_cache()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        return aux, grad_norm, _Graph(graph, static, static_aux, static_norm, launches)
