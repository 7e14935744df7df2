#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sample_factory_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  build     compile the hand-written kernels (csrc/rnn_seq.cu, sm_90a) from the checkout; read the card's spec
            (cuda_rnn.card_spec: SMs, clusters of 8 and 16 at once, a block's shared memory), hold the cluster
            and grid plans to it, and on a card of the H100 SXM's 132 SMs every path's plan to cuda_rnn.H100_SXM's
  parity    each kernel against its plain PyTorch version on the card, forward and
            gradient, float32 and bfloat16, at the main-path shape, the default width
            and odd shapes; every design of the launch plan (cluster, grid and rows) runs; then the
            doom, dmlab, nethack, isaacgym, dp_host, tp and defaults paths' shapes in float32, each asserting the
            design its plan picks (GRU-512 at (32, 64, 512), (16, 4, 512) and (32, 32, 512) and LSTM-512 at
            (32, 32, 512), (32, 24, 512) and (16, 2048, 512): grid; dp_host's GRU-256 at 37, 128, 131 and 255
            segments: clusters of 8; DMLab's LSTM-64 at (16, 64, 64), (16, 1024, 64) and (16, 128, 64): resident); the gradient goes
            through the backward kernel; then the planned backward kernels (the grid design, `gru_seq_grid_bwd`,
            `lstm_seq_grid_bwd`, where the forward takes the grid design; the cluster design, `gru_seq_cluster_bwd`,
            `lstm_seq_cluster_bwd`, where it takes the cluster design; the resident design, `lstm_seq_resident_bwd`,
            where it takes the resident design: DMLab's instruction encoder over a minibatch; the row design, `gru_seq_bwd`,
            `lstm_seq_bwd`, elsewhere: bf16 at H=1024) against their
            plain recurrence (the same prologue, epilogue and inputs) and against the remat (the plain forward rerun
            under autograd, the CPU's backward) at the parity shapes in both dtypes, at every learner site
            (BWD_SITES), on rows reset at every step and on gates saturated below -88, in both dtypes; both resident
            kernels (`lstm_seq_resident`, `lstm_seq_resident_bwd`) against their plain versions at DMLab's
            instruction-encoder sites and (16, 2048, 64) (RESIDENT_SITES) and at odd shapes (RESIDENT_ODD_SHAPES), in both
            dtypes, on rows reset at every step, gates below -88 and x_proj at an odd offset; lstm_seq_in's kernels
            (`lstm_seq_resident_in`, with and without the backward's buffers, and `lstm_seq_resident_in_bwd` on them) the
            same way against their plain versions, and the gradient through `lstm_seq_in` at DMLab's learner against
            autograd through the plain version; S1: the grid design at 8 x 8 tiles on an x_proj one float into its buffer
            (S1_SHAPE)
  timing    each kernel, its plain version and the bound at the main-path shapes and the doom, dmlab,
            nethack, isaacgym, dp_host, tp and defaults paths' shapes, warm and with L2 flushed, beside the first
            design (rows) at the same shapes (and the cluster plan where the row design takes its place), in turns in
            one call; each kernel in both dtypes at (32, 512, 256); torch.nn.GRU (cuDNN) as a yardstick; at
            RESIDENT_SITES the resident design in turns with the row design and the cluster plan where there is one, warm
            and L2-cold; lstm_seq_in's kernel in turns with the unfused route (the Linear that makes x_proj, then the
            resident kernel), warm and L2-cold; at DMLab's float32 sites the instruction encoder's three routes in turns:
            `lstm_seq_in`, the Linear + `lstm_seq`, and cuDNN's torch.nn.LSTM(20, 64) on the same embedding (the forget
            offset in bias_ih; its outputs held against the plain version; `library_ms`, the port never calls it),
            forward in the site's grad mode and backward; then every device activity of each route, profiled
            (`route_profile`)
  bwd       at every learner site: the planned backward kernel alone (warm and L2-cold; at the grid and cluster
            sites in turns with the row design at the same shape, and where the other count of receive buffers takes
            other rows, `selfplay`, with that plan too), the whole backward (prologue, kernel,
            epilogue) and the remat in turns at the first site of each kernel, in CUDA-event and host-clock ms and the
            device's busy ms; the plain recurrence; the kernel's bound, bytes and operations; the resident backward at
            the RESIDENT_SITES no learner runs, in turns with the row design; lstm_seq_in's backward kernel on its
            forward's buffers at every RESIDENT_SITE, in turns with the resident backward that recomputes the cell states
  plans     the plans made for smaller cards (SMALLER_CARDS: 114 SMs with clusters {8: 13, 16: 0}, 66 SMs with
            {8: 7, 16: 3}) at the grid and cluster sites, launched on this card against the plain version and
            timed warm in turns with this card's own plan; the same for the backward's cluster plans at its sites
  main      sync PPO on grid_battle at full width (IMPALA conv, GRU-256, bf16,
            1024 envs, rollout 32) for 3 iterations through `run_rl`'s runner
  breakdown one more main-path iteration: rollout and learner times, then one under
            torch.profiler for the device's busy share and its top kernels
  lstm      the --rnn_type=lstm path (float32, 128 envs, 1 iteration), then the
            trained model on the card against the same model on the CPU
  appo      the default regime at full width: the `main` configuration without --async_rl
            (so async, a behaviour snapshot one train call behind) and with V-trace, 3
            iterations; the policy lag, and env steps/s beside the sync run's
  defaults  `train_synthetic` with --use_rnn=True and no model flag: the cfg's defaults (GRU-512 float32,
            batch 1024, rollout 32, async), 64 envs, 2 iterations; `gru_seq_grid` once a minibatch at (32, 32, 512)
  dp        data parallelism (`parallel/`), in child processes that import nothing of JAX: (a) `main`
            in a world of 1 over NCCL, through the port's train.py with --jax_distributed=True under
            `python -m torch.distributed.run`, in turns with the same run without a group in the same
            process (group, none, none, group): env steps/s and their ratio, the all-reduces and the NCCL kernels' device time of an
            iteration (torch.profiler), GRU launches, one checkpoint; (b) two gloo ranks of 512 envs on
            cuda:0 (LOCAL_RANK=0 in both) against one rank of 1024, `main` in float32 at one sync GAE
            iteration of 2 shuffled minibatches (each holds rows of both ranks): the ranks' reset rows,
            at least DP_ACTIONS_EQUAL of the rollout's actions equal to the one-rank rollout's rows, the
            parameters after the train call within DP_TOL and its stats (DP_STATS) within DP_STATS_TOL
            of the one rank's, the two replicas equal
  tp        tensor parallelism over the 'model' axis, gloo ranks on cuda:0 (NCCL takes one rank a card), in
            child processes that import nothing of JAX: first a probe of each collective the path uses on
            cuda:0 tensors; (a) `main` in float32 on a 1 x 2 mesh (the GRU's wi, wh, bi, bh sharded at the
            default --tp_min_layer_width=512) against one rank of 1024 envs: the rollout (acting with the
            whole parameters, gathered in one collective) gives the two ranks equal actions bit for bit and
            at least TP_ACTIONS_EQUAL of them equal to one rank's, the gathered parameters after one sync
            train call of 2 shuffled minibatches within TP_TOL, `gru_seq` on the gathered `wh` once a
            minibatch on each rank at (32, 512, 256), the collectives (calls, bytes, host ms) of the rollout
            and the train call, and the device busy ms of a profiled iteration beside the one rank's; (b) the
            JAX package's multichip configuration (`__graft_entry__.py`: convnet_atari + Dense 512, GRU-512
            float32) on a 2 x 2 mesh of four ranks against 4 x 1 for one iteration: the grid design
            (`gru_seq_grid`, a cooperative launch of 128 blocks on each rank) on the gathered `wh` at
            TP_MULTICHIP_GRU, which `parity` and `timing` hold
  ant       continuous control at full width: the physics ant, MLP 256-128-64, 4096 envs,
            rollout 16, batch 32768, 4 epochs, sync; env steps/s and the rollout/learner split
  towers    the other model family through the LSTM kernel: resnet_impala, separate actor
            and critic towers, 2-layer LSTM-256, LAMB with lookahead, float32, 128 envs,
            1 iteration; the trained model on the card against a copy on the CPU
  population the `main` configuration with --num_policies=2 --with_pbt=True (unmixed: 512 envs a
            policy), 4 iterations with two PBT rounds in which policy 1 is the worst: its files,
            its shaping in the sampler state, per-policy checkpoints, and the exploit copy
            (`_replace_weights`) checked tensor by tensor on the card
  selfplay  grid_duel (2 agents) at full width: resnet_impala, GRU-512 (the default rnn_size),
            bf16, 2 policies mixed inside every env, 512 envs (1024 slots), 3 iterations; each
            policy trains on the shared trajectory masked to its slots; then one train call in
            float32 at a cut depth on the card against the same call on a CPU copy
  enjoy     `enjoy` on the checkpoint that `appo` wrote, on the card, 16 envs; then with
            --policy_index=1 on `population`'s
  export    `export_model` (torch.export) of `main`'s checkpoint at batch 1024 on the card; the
            reloaded program steps 1024 envs for 32 steps with its own rnn state fed back, beside
            the eager deterministic policy on the same inputs (rnn state within 0.03, equal actions
            where the top two logits differ by more); its outputs on cuda:0; ms per step of both;
            the sampling program (draws as an input) once, actions in range
  host      host envs at full width: `bench_host_pixel` (42x42x4 uint8 frames, 6 actions), 2 worker
            processes x 1024 envs in 2 splits over the shared-memory queue, rollout 32, batch 8192,
            convnet_simple + MLP 128, the default regime (async: learner quanta dispatched inside the
            rollouts, a behaviour snapshot), 6 iterations; per-slot host times; then the same
            configuration with --async_rl=False in turns with it
  host_rnn  the same with GRU-256 over BPTT segments of 32 in bf16, 3 iterations: the learner's
            `gru_seq` launches at (32, 256, 256), none in the rollout's step mode; then the learner's train
            call on the last trajectory in turns with the planned backward kernel (`gru_seq_cluster_bwd`), the row
            design's (`gru_seq_bwd`) and the remat (`learner_turns`)
  dp_host   the host runners under a process group, in child processes that import nothing of JAX: (a) two
            gloo ranks on cuda:0 (LOCAL_RANK=0 in both), each with its own sampler over 1 worker x 256
            `bench_host_pixel` envs, `host_rnn` in float32 with the quantized learner (2 shuffled minibatches
            of 8,192 of the 16,384 rows both ranks hold, 2 epochs), 2 iterations, against one rank handed
            the ranks' first trajectories joined on the env axis in rank order: the parameters of the first
            flushed train step within DP_TOL, its stats (DP_HOST_STATS) within DP_STATS_TOL, the replicas
            equal after the run, the envs seeded apart and the actions drawn apart, `gru_seq` once a
            minibatch on each rank, one checkpoint, written by rank 0; (b) `host` in a world of 1 over NCCL
            under `python -m torch.distributed.run`, in turns with the same run without a group (after an
            uncounted warm-up run: group, none, none, group; 3 iterations each): env steps/s and their
            ratio, the all-reduces an iteration, one profiled iteration's NCCL kernels and device time
  host_selfplay  the 2-agent matching game (a host env), 2 policies mixed inside the envs, 2 worker
            processes, PBT once: `policy_id` against the slot mapping and `active`, the mapping drawn
            anew, the mutated shaping in the workers' envs, both policies' checkpoints
  host_enjoy  `enjoy` and `eval` on the checkpoint that `host` wrote
  custom_model  `examples/train_custom_env_custom_model.py` at its own defaults (2 workers x 32 envs of the
            42x42x4 quadrant task, async, the quantized learner, its registered encoder on the card) for
            300,000 env steps: average episode reward at least 100 (random play 32); then `enjoy`
  atari     `examples/envpool/train_envpool_atari.py` (envpool_atari_breakout, atari_params: convnet_atari +
            Dense 512 over 84x84x4 uint8, sync PPO, 4 epochs of 256-sample minibatches) with 8 workers x 32
            envs in 2 splits over the stand-in envpool module of tests/standins/ (the card's machine has
            none): 4 iterations; the 4th's rollout and first epoch under the profiler, against the 3rd's
            unprofiled; uint8 frames on cuda:0, the decaying learning rate, no RNN kernel
  doom      the paper's doom_battle command line (`sf_examples_tpu/vizdoom/experiments/doom_battle_appo.py`)
            through `examples/vizdoom/train_vizdoom.py`'s flags: GRU-512 float32, convnet_simple over
            72x128x3 + the measurements MLP, the tuple head, 400 envs, batch 2048, async with the
            quantized learner, 4 iterations, over the env-level stand-in of tests/standins/ (the card's
            machine has neither gymnasium nor vizdoom); `gru_seq_grid` once a minibatch at (32, 64, 512); then
            the learner's train call in turns with the backward kernel and with the remat, as `host_rnn`
  dmlab     dmlab_30 at dmlab_params (convnet_impala ++ the instruction encoder, LSTM-256 float32), 128
            envs of the port's DmlabEnv with its level cache over the stand-in deepmind_lab of
            tests/standins/, batch 1024, async, 4 iterations, the DMLab-30 score tracker registered;
            LSTM launches by site (the core: the cluster design, `lstm_seq`; the instruction encoder in the rollout, the
            learner and the learner's last-value pass: lstm_seq_in's fused kernel, `lstm_seq_resident_in`, with
            `lstm_seq_resident_in_bwd` once for each of the learner's forwards, every call of lstm_seq_in there on the
            fused route; no `lstm_seq_resident`, no `lstm_seq_rows`, no `lstm_seq_bwd`)
  nethack   nethack_challenge through `examples/nethack/train_nethack.py`'s flags at their defaults (LSTM-512
            float32, batch 1024, rollout 32, async with the quantized learner; 12 workers x 2 envs, cut to one
            worker a core keeping the 24 envs) over the env-level stand-in of tests/standins/ (the card's
            machine has neither gymnasium nor nle): ChaoticDwarvenGPT5 over the 108x108x2 screen image for 4
            iterations, then ScaledNet (h_dim 1738, the crop branch, GroupNorm) for 2; `lstm_seq_grid` once a
            train step at (32, 24, 512) (a train step takes one rollout: 768 samples), the extra stats
  isaacgym  `examples/isaacgym_examples/train_isaacgym.py` at its per-task defaults (serial, sync) over the
            stand-ins of isaacgym, isaacgymenvs and hydra in tests/standins/ (a batched torch sim on cuda:0):
            Ant (MLP 256-128-64, 4096 sim agents) for 4 iterations, AllegroHandLSTM (sim states, LSTM-512
            float32, 16384 sim agents) for 2, `lstm_seq_grid` 8 an epoch at (16, 2048, 512); the host's
            time converting the sim's tensors a step
  bench     `bench_gpu.py --smoke` (the port's benchmark, every scenario at a cut depth) in a child process: exit 0,
            every row in order with a value, the card's name and power limit, no error row, no mfu_violation,
            flops_xcheck_ratio in [0.9, 1.5], the headline (ant_physics_sync_ppo, with the suite) last
  sampler   `examples/sampler/use_simplified_sampling_api.generate_trajectories` on its fallback (no ALE):
            the synthetic env on the card for 200,000 env steps
Then a `kernels` line (each kernel's launches per path, `dp` and `dp2` (the two legs of `dp`), `tp` (both legs' tensor-parallel
runs) and `dp_host` included, and per design: cluster, `*_seq`, grid, `*_seq_grid`, and rows,
`*_seq_rows`; `gru_seq_grid` and `lstm_seq_grid` also as kernels of their own, by site: the Doom learner, `tp`'s
multichip leg and the defaults, the NetHack and AllegroHandLSTM learners, beside the row design at the same
shapes; the backward's designs, `gru_seq_bwd` and `lstm_seq_bwd` (rows), `gru_seq_grid_bwd` and `lstm_seq_grid_bwd`
(grid) and `gru_seq_cluster_bwd` and `lstm_seq_cluster_bwd` (cluster), by path and at every learner site each runs, the
grid and cluster designs beside the row design at the same shapes); `lstm_seq_resident` and `lstm_seq_resident_bwd`, by
path and by site (RESIDENT_SITES), beside the row design, the cluster plan and cuDNN; `lstm_seq_resident_in` and
`lstm_seq_resident_in_bwd` the same way, beside the unfused route and cuDNN; every recurrent path's launches hold one backward
launch for each learner forward launch (rollouts run under no_grad and launch none), of the forward's design; the card's
name and power limit, and the result line.
Needs one CUDA card; exits non-zero on any failure. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

from sample_factory_tpu_torch.utils.device_profile import card_line, device_activities, profiled_device_time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 outside the tensor cores
MAIN_GRU = (32, 512, 256, "bfloat16")  # T, segments per minibatch (16384 / 32), H, dtype
MAIN_LSTM = (32, 128, 256, "float32")  # the lstm phase: 128 envs x 32 steps in one minibatch
SELFPLAY_GRU = (32, 512, 512, "bfloat16")  # the selfplay phase: the default rnn_size, 512 segments a minibatch
HOST_GRU = (32, 256, 256, "bfloat16")  # the host_rnn phase: 8192 / 32 segments a minibatch
# (32, 512, 512): the default rnn_size; (4, 16, 1024): no cluster slice fits, the row design in bf16, the grid design in float32
PARITY_SHAPES = [(32, 512, 256), (7, 24, 128), (1, 8, 128), (5, 3, 64), (32, 512, 512), (4, 16, 1024)]
# the doom and dmlab paths' shapes in the dtype each path runs, with the design its plan picks
# (kind, T, B, H, dtype, design, cluster): GRU-512 float32 over 2048 / 32 segments; the DMLab core's
# LSTM-256 over 1024 / 32; the instruction encoder's LSTM-64 over 16 tokens in a rollout slot (64 envs
# a split), in a minibatch of 1024 (its cluster plan, 32 clusters, would need three waves) and in the
# learner's value of the last observation of all 128 envs: the resident design at all three
DOOM_GRU = (32, 64, 512, "float32")
DMLAB_CORE = (32, 32, 256, "float32")
DMLAB_INSTR_ROLLOUT = (16, 64, 64, "float32")
DMLAB_INSTR_LEARNER = (16, 1024, 64, "float32")
DMLAB_INSTR_BOOTSTRAP = (16, 128, 64, "float32")
# the resident design (the LSTM at H <= 64, over a cluster plan of several waves or of one): DMLab's instruction-encoder sites, which all take it, and the learner's batch at twice the rows in bf16;
# phases parity, timing and bwd hold and time both kernels there
RESIDENT_SITES = {"dmlab_instruction_rollout": DMLAB_INSTR_ROLLOUT, "dmlab_instruction_last_value": DMLAB_INSTR_BOOTSTRAP,
                  "dmlab_instruction_learner": DMLAB_INSTR_LEARNER, "bf16_2048": (16, 2048, 64, "bfloat16")}
# odd shapes of the resident design: B not a multiple of a block's rows, B=1, T=1
RESIDENT_ODD_SHAPES = [(5, 1001, 64), (3, 1, 64), (1, 1024, 64)]
DMLAB_INSTRUCTION_EMBED = 20  # the instruction encoder's embedding width: its LSTM is torch.nn.LSTM(20, 64) for cuDNN
# S1 (ROADMAP C): a float32 x_proj one float into its buffer at a shape the grid design takes with 8 x 8 register tiles
S1_SHAPE = (2, 1024, 512)
# the NetHack and IsaacGym paths: LSTM-512 float32 takes the grid design (no cluster slice fits). NetHack's
# defaults name batch 1024 (32 segments of 32); a train step takes one rollout of the 24 envs, 768 samples
# (the quantized learner clips the batch to the rollout), so its learner launches at 24 segments.
# AllegroHandLSTM: 16384 sim agents x 16 steps in 8 minibatches of 32768 (2048 segments), 4 epochs.
NETHACK_LSTM_BATCH = (32, 32, 512, "float32")
NETHACK_LSTM = (32, 24, 512, "float32")
ALLEGRO_LSTM = (16, 2048, 512, "float32")
# dp_host: GRU-256 float32 over the segments of one rank's share of a shuffled minibatch, which the
# shuffle varies from 1 to 256 (about 128 at two ranks): 16 rows a cluster, full (128) and with a partly
# filled last cluster (131); 8 rows (37) and 24 rows (255), each with a partly filled last cluster
DP_HOST_GRUS = [(32, B, 256, "float32") for B in (128, 131, 37, 255)]
# tp leg (b): the JAX package's multichip configuration, GRU-512 float32 on the gathered `wh` over one data
# index's contiguous minibatch, 4 segments of 16 steps
TP_MULTICHIP_GRU = (16, 4, 512, "float32")
# the cfg's defaults (--use_rnn=True --rnn_type=gru --rnn_size=512 --compute_dtype=float32 --batch_size=1024
# --rollout=32): 1024 / 32 segments a minibatch (phase `defaults`)
DEFAULTS_GRU = (32, 32, 512, "float32")
# GRU-512 and LSTM-512 float32 take the grid design (128 blocks at these batches, 32 at AllegroHandLSTM's);
# the DMLab instruction encoder's LSTM-64 the resident design (over a minibatch its cluster plan needs three waves)
PARITY_PATH_SHAPES = [("gru", *DOOM_GRU, "grid", 128), *[("gru", *shape, "cluster", 8) for shape in DP_HOST_GRUS],
                      ("gru", *TP_MULTICHIP_GRU, "grid", 128), ("gru", *DEFAULTS_GRU, "grid", 128),
                      ("lstm", *DMLAB_CORE, "cluster", 8), ("lstm", *DMLAB_INSTR_ROLLOUT, "resident", 1),
                      ("lstm", *DMLAB_INSTR_LEARNER, "resident", 1), ("lstm", *DMLAB_INSTR_BOOTSTRAP, "resident", 1),
                      ("lstm", *NETHACK_LSTM_BATCH, "grid", 128), ("lstm", *NETHACK_LSTM, "grid", 128),
                      ("lstm", *ALLEGRO_LSTM, "grid", 32)]
# GRU-1024 and LSTM-1024 bf16 over 16 segments of 16 steps (--rnn_size=1024): no cluster slice fits, so the forward and the
# backward keep the row design; no path runs them
GRU_1024 = (16, 16, 1024, "bfloat16")
LSTM_1024 = (16, 16, 1024, "bfloat16")
# the learner sites of the backward kernels (every forward launch that needs a gradient is a learner's):
# site -> (kind, shape, the path that runs it, or None); phases `parity` and `bwd` hold and time the backward at each
BWD_SITES = {"main": ("gru", MAIN_GRU, "main"), "selfplay": ("gru", SELFPLAY_GRU, "selfplay"), "host_rnn": ("gru", HOST_GRU, "host_rnn"),
             "doom_learner": ("gru", DOOM_GRU, "doom"), "defaults": ("gru", DEFAULTS_GRU, "defaults"),
             "tp_multichip": ("gru", TP_MULTICHIP_GRU, "tp"), **{f"dp_host_{s[1]}": ("gru", s, "dp_host") for s in DP_HOST_GRUS},
             "lstm": ("lstm", MAIN_LSTM, "lstm"), "dmlab_core": ("lstm", DMLAB_CORE, "dmlab"),
             "dmlab_instruction_learner": ("lstm", DMLAB_INSTR_LEARNER, "dmlab"), "nethack_learner": ("lstm", NETHACK_LSTM, "nethack"),
             "allegro_hand_lstm_learner": ("lstm", ALLEGRO_LSTM, "isaacgym"), "gru_1024": ("gru", GRU_1024, None),
             "lstm_1024": ("lstm", LSTM_1024, None)}
# the backward kernel of each design (cuda_rnn.bwd_plan: the grid design exactly at GRID_SITES, the cluster design where the
# forward takes it, the row design elsewhere) -> the learner site whose numbers the kernels line gives first, the first of
# its kind and design in BWD_SITES
BWD_LINE_SITES = {"gru_seq_cluster_bwd": "main", "lstm_seq_cluster_bwd": "lstm", "gru_seq_grid_bwd": "doom_learner",
                  "lstm_seq_grid_bwd": "nethack_learner", "gru_seq_bwd": "gru_1024", "lstm_seq_bwd": "lstm_1024",
                  "lstm_seq_resident_bwd": "dmlab_instruction_learner"}
# the sites of the grid design that the kernels line reports one by one: site -> (kind, shape, the path that runs it)
GRID_SITES = {"doom_learner": ("gru", DOOM_GRU, "doom"), "tp_multichip": ("gru", TP_MULTICHIP_GRU, "tp"),
              "defaults": ("gru", DEFAULTS_GRU, "defaults"), "nethack_learner": ("lstm", NETHACK_LSTM, "nethack"),
              "allegro_hand_lstm_learner": ("lstm", ALLEGRO_LSTM, "isaacgym")}
# the cluster design's sites that the build phase checks against the clusters the card runs at once:
# name -> (kind, shape); DMLab's instruction encoder takes the resident design over these cluster plans
CLUSTER_SITES = {"gru_seq": ("gru", MAIN_GRU), "lstm_seq": ("lstm", MAIN_LSTM), "gru_seq_selfplay": ("gru", SELFPLAY_GRU),
                 "lstm_seq_dmlab_core": ("lstm", DMLAB_CORE), "lstm_seq_dmlab_instr_rollout": ("lstm", DMLAB_INSTR_ROLLOUT),
                 "lstm_seq_dmlab_instr_learner": ("lstm", DMLAB_INSTR_LEARNER),
                 "lstm_seq_dmlab_instr_last_value": ("lstm", DMLAB_INSTR_BOOTSTRAP)}
# phase `plans`: the smaller cards whose plans run here, (SMs, clusters of 8, clusters of 16 at once): the H100
# PCIe's SM count in a GPC layout where no cluster of 16 fits, and half the H100 SXM's SMs
SMALLER_CARDS = [(114, 13, 0), (66, 7, 3)]
# the card's spec (cuda_rnn.card_spec of cuda:0), read by main() before any plan is made
SPEC = None
# each path's forward launches by site where a phase counts them (`dmlab`: the instruction encoder's sites): path -> site ->
# {"kernel": the planned kernel, "launches": its launches there}
SITE_LAUNCHES = {}
# bf16: kernel and plain version round every gate op to bf16 alike, but sum h @ wh in
# another order, so a product can land one bf16 ulp apart; that flip (2^-8 relative,
# up to 2^-6 absolute at the LSTM cell's magnitudes) feeds forward through the recurrence.
BF16_TOL = 0.0625
# gradients through the kernels (the forward, then the backward kernel) against autograd through the plain
# forward, relative to the largest gradient: in float32 they differ through the forward outputs that seed the
# backward and the order of the products' sums (3.1e-6 at most measured on an H100, at (16, 2048, 512));
# bf16 as the forward, 4 x BF16_TOL (0.018 at most measured)
GRAD_F32_TOL = 1e-4
# the backward kernel against its plain recurrence on the same inputs (the saved tensors, the prologue's
# projections, the cotangents), relative to the largest gradient: float32 differs in the order of the
# products' sums alone (8.5e-7 at most measured on an H100); bf16 also in the one-ulp flips that order
# causes where an output is rounded to bf16 (4.0e-3 at most measured)
BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_REPS = 5  # the whole backward and the remat launch from the host step by step: few repetitions
REPS = 25
SPIN_CYCLES = 1_000_000  # ~0.5 ms at the H100's 1980 MHz
L2_FLUSH_BYTES = 100 * 2**20  # written between reps of a cold timing: twice the H100's 50 MB L2
SOURCE = "sample_factory_tpu_torch/csrc/rnn_seq.cu"
REPLACES = {
    "gru_seq": "sample_factory_tpu/ops/pallas_gru.py:148",
    "lstm_seq": "sample_factory_tpu/ops/pallas_gru.py:271",
    # the backward kernels replace the custom_vjp's backward rules, jax.vjp of the scan (no pallas_call)
    "gru_seq_bwd": "sample_factory_tpu/ops/pallas_gru.py:189",
    "lstm_seq_bwd": "sample_factory_tpu/ops/pallas_gru.py:311",
    "gru_seq_grid_bwd": "sample_factory_tpu/ops/pallas_gru.py:189",
    "lstm_seq_grid_bwd": "sample_factory_tpu/ops/pallas_gru.py:311",
    "gru_seq_cluster_bwd": "sample_factory_tpu/ops/pallas_gru.py:189",
    "lstm_seq_cluster_bwd": "sample_factory_tpu/ops/pallas_gru.py:311",
    "lstm_seq_resident": "sample_factory_tpu/ops/pallas_gru.py:271",
    "lstm_seq_resident_bwd": "sample_factory_tpu/ops/pallas_gru.py:311",
    # lstm_seq_in's kernels: the Pallas LSTM with the input product (sample_factory_tpu/ops/rnn_cells.py:124) folded in, and the
    # backward rule on the buffers that forward saves
    "lstm_seq_resident_in": "sample_factory_tpu/ops/pallas_gru.py:271",
    "lstm_seq_resident_in_bwd": "sample_factory_tpu/ops/pallas_gru.py:311",
}
# the designs (cluster: `gru_seq`/`lstm_seq`; grid: `gru_seq_grid`/`lstm_seq_grid`; rows: `gru_seq_rows`/`lstm_seq_rows`);
# the kernels line reports the cluster designs at their main paths' shapes, the grid designs at the doom and
# nethack paths' and at each of their sites, and the row designs, which no float32 H=512 path runs since the
# grid designs, at the same shapes
KERNEL_LINE_SHAPES = {"gru_seq": ("gru", MAIN_GRU), "lstm_seq": ("lstm", MAIN_LSTM), "gru_seq_grid": ("gru", DOOM_GRU),
                      "lstm_seq_grid": ("lstm", NETHACK_LSTM), "gru_seq_rows": ("gru", DOOM_GRU), "lstm_seq_rows": ("lstm", NETHACK_LSTM)}


def emit(record):
    print(json.dumps(record), flush=True)


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def fwd_tol(dtype, T):
    return 1e-4 * max(1, T // 4) if dtype == "float32" else BF16_TOL


def make_inputs(torch, kind, T, B, H, dtype, seed=0, device="cuda"):
    import numpy as np

    rng = np.random.default_rng(seed)
    G = 3 if kind == "gru" else 4
    dt = getattr(torch, dtype)
    x = torch.tensor(rng.normal(size=(T, B, G * H)).astype(np.float32), device=device).to(dt)
    s0 = torch.tensor(rng.normal(size=(B, H * (1 if kind == "gru" else 2))).astype(np.float32), device=device)
    resets = torch.tensor((rng.random((T, B)) < 0.1).astype(np.float32), device=device)
    wh = torch.tensor((rng.normal(size=(H, G * H)) / math.sqrt(H)).astype(np.float32), device=device).to(dt)
    args = [x, s0, resets, wh]
    if kind == "gru":
        args.append(torch.tensor((rng.normal(size=(G * H,)) * 0.1).astype(np.float32), device=device).to(dt))
    return args


def rel_err(a, b):
    return float((a.float() - b.float()).abs().max()) / max(1.0, float(b.float().abs().max()))


def forward_launches(counts):
    """The forward kernels' launches, every design (the backward kernels', `*_bwd`, left out)."""
    return sum(v for k, v in counts.items() if not k.endswith("_bwd"))


def backward_launches(counts):
    """The backward kernels' launches, every design (`*_seq_bwd`, `*_seq_grid_bwd`, `*_seq_cluster_bwd`, `*_seq_resident_bwd`)."""
    return sum(v for k, v in counts.items() if k.endswith("_bwd"))


def others(counts, *names):
    """The launches of every kernel but `names` and the backward kernels of their kinds (every design)."""
    keep = set(names) | {f"{name.split('_seq')[0]}_seq{design}_bwd" for name in names
                         for design in ("", "_grid", "_cluster", "_resident", "_resident_in")}
    return {k: v for k, v in counts.items() if k not in keep}


def check_backward_launches(counts, where):
    """One backward launch for each forward launch: `counts` are those of the launches that needed a gradient
    (rollouts, value passes and model checks run under no_grad, outside them). The backward takes the grid, the
    cluster and the resident designs exactly where the forward does (cuda_rnn.bwd_plan), so each grid forward pairs with a
    `*_seq_grid_bwd`, each cluster forward with a `*_seq_cluster_bwd`, each resident forward with a `*_seq_resident_bwd` and
    each row forward with a `*_seq_bwd`."""
    for kind in ("gru", "lstm"):
        want = {"grid": counts[f"{kind}_seq_grid"], "cluster": counts[f"{kind}_seq"], "rows": counts[f"{kind}_seq_rows"],
                "resident": counts.get(f"{kind}_seq_resident", 0), "resident_in": counts.get(f"{kind}_seq_resident_in", 0)}
        got = {"grid": counts[f"{kind}_seq_grid_bwd"], "cluster": counts[f"{kind}_seq_cluster_bwd"], "rows": counts[f"{kind}_seq_bwd"],
               "resident": counts.get(f"{kind}_seq_resident_bwd", 0), "resident_in": counts.get(f"{kind}_seq_resident_in_bwd", 0)}
        check(got == want, f"{where}: {kind} backward launches {got}, expected {want}: {counts}")


def parity_case(torch, cuda_rnn, kind, kernel_fn, plain_fn, T, B, H, dtype, plan, path_shape=False):
    """The planned kernel once against its plain version, forward and gradient (the gradient through the
    backward kernel, launched once, against autograd through the plain version)."""
    args = make_inputs(torch, kind, T, B, H, dtype, seed=T + B + H)
    args = [a.requires_grad_(i != 2) for i, a in enumerate(args)]
    name = cuda_rnn._kernel_name(kind, plan)
    bwd = cuda_rnn._bwd_kernel_name(kind, cuda_rnn.bwd_plan(kind, B, H, dtype, SPEC))
    before = cuda_rnn.launch_counts()
    out, state = kernel_fn(*args)
    torch.cuda.synchronize()
    check(cuda_rnn.launch_counts()[name] == before[name] + 1, f"{kind} {(T, B, H)}: {name} was not launched")
    ref_out, ref_state = plain_fn(*args)
    wrt = [a for i, a in enumerate(args) if i != 2]
    grads = torch.autograd.grad((out**2).sum() + state.sum(), wrt)
    torch.cuda.synchronize()
    check(cuda_rnn.launch_counts()[bwd] == before[bwd] + 1, f"{kind} {(T, B, H)}: {bwd} was not launched")
    ref_grads = torch.autograd.grad((ref_out**2).sum() + ref_state.sum(), wrt)
    torch.cuda.synchronize()
    fwd = max(float((out - ref_out).detach().abs().max()), float((state - ref_state).detach().abs().max()))
    grad = max(rel_err(g, r) for g, r in zip(grads, ref_grads))
    tol = fwd_tol(dtype, T)
    grad_tol = GRAD_F32_TOL if dtype == "float32" else 4 * BF16_TOL
    emit({"phase": "parity", "kernel": name, "design": dataclasses.asdict(plan), "dtype": dtype, "shape": [T, B, H],
          "path_shape": path_shape, "fwd_max_abs_err": fwd, "fwd_tol": tol, "grad_rel_err": grad, "grad_tol": grad_tol})
    check(fwd <= tol, f"{kind} {dtype} {(T, B, H)}: forward error {fwd} > {tol}")
    check(grad <= grad_tol, f"{kind} {dtype} {(T, B, H)}: gradient error {grad} > {grad_tol}")


def phase_parity(torch, cuda_rnn):
    fns = {"gru": (cuda_rnn.gru_seq, cuda_rnn.gru_seq_reference), "lstm": (cuda_rnn.lstm_seq, cuda_rnn.lstm_seq_reference)}
    main_err = {}
    for kind, (kernel_fn, plain_fn) in fns.items():
        for dtype in ("float32", "bfloat16"):
            for T, B, H in PARITY_SHAPES:
                parity_case(torch, cuda_rnn, kind, kernel_fn, plain_fn, T, B, H, dtype, cuda_rnn.launch_plan(kind, T, B, H, dtype, SPEC))
    for kind, T, B, H, dtype, design, cluster in PARITY_PATH_SHAPES:
        plan = cuda_rnn.launch_plan(kind, T, B, H, dtype, SPEC)
        # the slices or clusters named are the H100 SXM's; another card's plan is held to its spec in `build`
        check(plan.design == design and (plan.cluster == cluster or SPEC != cuda_rnn.H100_SXM),
              f"{kind} {(T, B, H, dtype)} takes {plan}, not the {design} design")
        kernel_fn, plain_fn = fns[kind]
        parity_case(torch, cuda_rnn, kind, kernel_fn, plain_fn, T, B, H, dtype, plan, path_shape=True)
    # the resident design, both kernels on their own plans: at its sites and odd shapes in both dtypes, then rows reset at
    # every step, gates below -88 and x_proj at an odd offset at the learner's shape; S1 on the grid design
    resident = {(T, B, H, dtype): resident_parity_case(torch, cuda_rnn, T, B, H, dtype)
                for T, B, H in [shape[:3] for shape in RESIDENT_SITES.values()] + RESIDENT_ODD_SHAPES for dtype in ("float32", "bfloat16")}
    for site, shape in RESIDENT_SITES.items():
        main_err[f"lstm_seq_resident@{site}"], main_err[f"lstm_seq_resident_bwd@{site}"] = resident[shape]
    for variant in ("resets_every_step", "saturated", "odd_offset"):
        for dtype in ("float32", "bfloat16"):
            resident_parity_case(torch, cuda_rnn, *DMLAB_INSTR_LEARNER[:3], dtype, variant)
    # lstm_seq_in's kernels (the resident design with the input product folded in) the same way, then the gradient through
    # lstm_seq_in at the learner's site
    fused = {(T, B, H, dtype): resident_in_parity_case(torch, cuda_rnn, T, B, H, dtype)
             for T, B, H in [shape[:3] for shape in RESIDENT_SITES.values()] + RESIDENT_ODD_SHAPES for dtype in ("float32", "bfloat16")}
    for site, shape in RESIDENT_SITES.items():
        main_err[f"lstm_seq_resident_in@{site}"], main_err[f"lstm_seq_resident_in_bwd@{site}"] = fused[shape]
    for variant in ("resets_every_step", "saturated", "odd_offset"):
        for dtype in ("float32", "bfloat16"):
            resident_in_parity_case(torch, cuda_rnn, *DMLAB_INSTR_LEARNER[:3], dtype, variant)
    main_err["lstm_seq_in_grad"] = in_gradient_case(torch, cuda_rnn, *DMLAB_INSTR_LEARNER[:3])
    s1_parity_case(torch, cuda_rnn)
    # the error reported for each design: at the shape and dtype of the first path that runs it, and at
    # each site of the grid design
    line_shapes = dict(KERNEL_LINE_SHAPES, **{f"{kind}_seq_grid@{site}": (kind, shape) for site, (kind, shape, _) in GRID_SITES.items()})
    for name, (kind, (T, B, H, dtype)) in line_shapes.items():
        kernel_fn, plain_fn = fns[kind]
        args = make_inputs(torch, kind, T, B, H, dtype, seed=1)
        launch = cuda_rnn._launch_gru if kind == "gru" else cuda_rnn._launch_lstm
        plan = cuda_rnn.row_plan(kind, B, H) if name.endswith("_rows") else cuda_rnn.launch_plan(kind, T, B, H, dtype, SPEC)
        check(cuda_rnn._kernel_name(kind, plan) == name.split("@")[0], f"{name} at {(T, B, H, dtype)} takes {plan}")
        with torch.no_grad():
            out, state = launch(*args, plan=plan)
            torch.cuda.synchronize()
            ref_out, ref_state = plain_fn(*args)
        main_err[name] = max(float((out - ref_out).abs().max()), float((state - ref_state).abs().max()))
        check(main_err[name] <= fwd_tol(dtype, T), f"{name} at {(T, B, H, dtype)} disagrees with its plain version")
    # the backward kernels: at the parity shapes in both dtypes, at every learner site, on rows reset at every
    # step and on gates saturated below -88; each site's error goes to the kernels line
    for kind in ("gru", "lstm"):
        for dtype in ("float32", "bfloat16"):
            for T, B, H in PARITY_SHAPES:
                bwd_parity_case(torch, cuda_rnn, kind, T, B, H, dtype)
        for variant in ("resets_every_step", "saturated"):
            for dtype in ("float32", "bfloat16"):
                bwd_parity_case(torch, cuda_rnn, kind, 8, 64, 256, dtype, variant)
    for site, (kind, (T, B, H, dtype), _) in BWD_SITES.items():
        name = cuda_rnn._bwd_kernel_name(kind, cuda_rnn.bwd_plan(kind, B, H, dtype, SPEC))
        main_err[f"{name}@{site}"] = bwd_parity_case(torch, cuda_rnn, kind, T, B, H, dtype, site=site)
    # (abs, rel) at the first learner site of each backward kernel
    for name, site in BWD_LINE_SITES.items():
        main_err[name] = main_err[f"{name}@{site}"]
    main_err["lstm_seq_resident"] = main_err["lstm_seq_resident@dmlab_instruction_learner"]
    main_err["lstm_seq_resident_in"] = main_err["lstm_seq_resident_in@dmlab_instruction_learner"]
    main_err["lstm_seq_resident_in_bwd"] = main_err["lstm_seq_resident_in_bwd@dmlab_instruction_learner"]
    return main_err


def odd_view(torch, t):
    """t's values in a contiguous view one element into a buffer of its own: an address that is no multiple of 16."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view_as(t).copy_(t)
    check(view.data_ptr() % 16 != 0 and view.is_contiguous(), "the view is not at an odd offset")
    return view


def resident_parity_case(torch, cuda_rnn, T, B, H, dtype, variant=None):
    """Both resident kernels once on their own plans at this shape (whatever the launch plan takes there) against the plain
    versions on the same inputs: the forward within fwd_tol, the backward kernel (on the prologue's proj of the kernel
    forward's outputs) within BWD_TOL of the largest gradient. `variant`: "resets_every_step"; "saturated" (the sigmoid
    gates' pre-activations of the first quarter of the rows at -200: their gradient must be 0); "odd_offset" (x_proj and
    proj as views one element into their buffers). Returns (forward error, (backward abs, rel))."""
    import numpy as np

    fwd = cuda_rnn.resident_plan("lstm", B, H, dtype, SPEC)
    bwd = cuda_rnn.resident_plan("lstm", B, H, dtype, SPEC, backward=True)
    args = make_inputs(torch, "lstm", T, B, H, dtype, seed=T + B + H + 3)
    quarter = max(1, B // 4)
    if variant == "resets_every_step":
        args[2].fill_(1.0)
    if variant == "saturated":
        for g in (0, 1, 3):
            args[0][:, :quarter, g * H:(g + 1) * H] = -200.0
    odd = variant == "odd_offset"
    with torch.no_grad():
        before = cuda_rnn.launch_counts()
        out, state = cuda_rnn._launch_lstm(odd_view(torch, args[0]) if odd else args[0], *args[1:], plan=fwd)
        rng = np.random.default_rng(B + 7)
        d_out = torch.tensor(rng.normal(size=tuple(out.shape)).astype(np.float32), device="cuda")
        d_state = torch.tensor(rng.normal(size=tuple(state.shape)).astype(np.float32), device="cuda")
        proj = args[0] + cuda_rnn._carries_in(args[1], args[2], out).to(args[0].dtype) @ args[3]
        got = cuda_rnn._launch_lstm_bwd(d_out, d_state, args[2], odd_view(torch, proj) if odd else proj, args[1], args[3], plan=bwd)
        torch.cuda.synchronize()
        after = cuda_rnn.launch_counts()
        check({k: after[k] - before[k] for k in after} == {**dict.fromkeys(after, 0), "lstm_seq_resident": 1, "lstm_seq_resident_bwd": 1},
              f"resident {(T, B, H, dtype, variant)}: launches {after} after {before}")
        ref_out, ref_state = cuda_rnn.lstm_seq_reference(*args)
        want = cuda_rnn.lstm_seq_bwd_reference(d_out, d_state, args[2], proj, args[1], args[3])
        torch.cuda.synchronize()
    fwd_err = max(float((out - ref_out).abs().max()), float((state - ref_state).abs().max()))
    bwd_err = max(rel_err(g, w) for g, w in zip(got, want))
    bwd_abs = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(t).all()) for t in (out, state, *got))
    tol = fwd_tol(dtype, T)
    emit({"phase": "parity", "kernel": "lstm_seq_resident", "backward_kernel": "lstm_seq_resident_bwd", "shape": [T, B, H],
          "dtype": dtype, "variant": variant, "design": dataclasses.asdict(fwd), "backward_design": dataclasses.asdict(bwd),
          "fwd_max_abs_err": fwd_err, "fwd_tol": tol, "grad_rel_err_plain": bwd_err, "grad_max_abs_err_plain": bwd_abs,
          "tol_plain": BWD_TOL[dtype], "finite": finite})
    where = f"resident {(T, B, H, dtype, variant)}"
    check(finite, f"{where}: non-finite outputs or gradients")
    check(fwd_err <= tol, f"{where}: forward error {fwd_err} > {tol}")
    check(bwd_err <= BWD_TOL[dtype], f"{where}: backward against the plain recurrence {bwd_err} > {BWD_TOL[dtype]}")
    if variant == "saturated":
        check(all(bool((got[0][:, :quarter, g * H:(g + 1) * H] == 0).all()) for g in (0, 1, 3)), f"{where}: a gate below -88 has a gradient")
    if variant == "resets_every_step":
        check(bool((state == 0).all()), f"{where}: a carry survived a reset")
    return fwd_err, (bwd_abs, bwd_err)


def in_inputs(torch, T, B, H, dtype, seed, I=None):
    """lstm_seq_in's inputs as DMLab's instruction encoder gives them: x [T,B,I] a transposed view of an embedding [B,T,I]
    (I = DMLAB_INSTRUCTION_EMBED), wi, bi, hc0, resets, wh, from a seed."""
    import numpy as np

    I = I or DMLAB_INSTRUCTION_EMBED
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    x = torch.tensor(rng.normal(size=(B, T, I)).astype(np.float32), device="cuda").to(dt).transpose(0, 1)
    wi = torch.tensor((rng.normal(size=(I, 4 * H)) / math.sqrt(I)).astype(np.float32), device="cuda").to(dt)
    bi = torch.tensor((rng.normal(size=(4 * H,)) * 0.1).astype(np.float32), device="cuda").to(dt)
    hc0 = torch.tensor(rng.normal(size=(B, 2 * H)).astype(np.float32), device="cuda")
    resets = torch.tensor((rng.random((T, B)) < 0.1).astype(np.float32), device="cuda")
    wh = torch.tensor((rng.normal(size=(H, 4 * H)) / math.sqrt(H)).astype(np.float32), device="cuda").to(dt)
    return [x, wi, bi, hc0, resets, wh]


def resident_in_parity_case(torch, cuda_rnn, T, B, H, dtype, variant=None):
    """Both kernels of lstm_seq_in (`lstm_seq_resident_in`, `lstm_seq_resident_in_bwd`) once on their plans at this shape against
    the plain versions on the same inputs: the forward, without and with the backward's buffers, against
    lstm_seq_in_saved_reference within fwd_tol (the buffers relative to their largest value; saving changes no output); the
    backward kernel, on the buffers the forward saved, against lstm_seq_bwd_reference within BWD_TOL of the largest
    gradient. `variant`: "resets_every_step"; "saturated" (the sigmoid gates of the first quarter of the rows driven below -88
    through one column of wi: their gradient must be 0); "odd_offset" (x a contiguous view one element into its buffer).
    Returns (forward error, (backward abs, rel))."""
    fwd = cuda_rnn.resident_in_plan(T, B, H, DMLAB_INSTRUCTION_EMBED, getattr(torch, dtype), SPEC)
    bwd = cuda_rnn.resident_plan("lstm", B, H, dtype, SPEC, backward=True)
    x, wi, bi, hc0, resets, wh = args = in_inputs(torch, T, B, H, dtype, seed=T + B + H + 5)
    quarter = max(1, B // 4)
    gates = torch.cat([torch.arange(g * H, (g + 1) * H) for g in (0, 1, 3)]).cuda()
    if variant == "resets_every_step":
        resets.fill_(1.0)
    if variant == "saturated":
        wi[0] = 0.0
        wi[0, gates] = -1.0
        x[:, :, 0] = 0.0
        x[:, :quarter, 0] = 300.0
    if variant == "odd_offset":
        args[0] = odd_view(torch, x.contiguous())
    with torch.no_grad():
        before = cuda_rnn.launch_counts()
        out, state, *_ = cuda_rnn._launch_lstm_in(*args, plan=fwd)
        out2, state2, proj, cells, xh = cuda_rnn._launch_lstm_in(*args, save=True, plan=fwd)
        d_out, d_state = (torch.randn(*t.shape, device="cuda", generator=torch.Generator(device="cuda").manual_seed(B)) for t in (out, state))
        got = cuda_rnn._launch_lstm_in_bwd(d_out, d_state, resets, proj, hc0, wh, cells, plan=bwd)
        torch.cuda.synchronize()
        after = cuda_rnn.launch_counts()
        check({k: after[k] - before[k] for k in after} == {**dict.fromkeys(after, 0), "lstm_seq_resident_in": 2, "lstm_seq_resident_in_bwd": 1},
              f"resident_in {(T, B, H, dtype, variant)}: launches {after} after {before}")
        ref = cuda_rnn.lstm_seq_in_saved_reference(*args)
        want = cuda_rnn.lstm_seq_bwd_reference(d_out, d_state, resets, proj, hc0, wh, cells)
        torch.cuda.synchronize()
    fwd_err = max(float((out - ref[0]).abs().max()), float((state - ref[1]).abs().max()))
    saved_err = max(rel_err(g, w) for g, w in zip((proj, cells, xh), ref[2:]))
    bwd_err = max(rel_err(g, w) for g, w in zip(got, want))
    bwd_abs = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(t).all()) for t in (out, state, proj, cells, *got))
    tol = fwd_tol(dtype, T)
    emit({"phase": "parity", "kernel": "lstm_seq_resident_in", "backward_kernel": "lstm_seq_resident_in_bwd", "shape": [T, B, H],
          "input": DMLAB_INSTRUCTION_EMBED, "dtype": dtype, "variant": variant, "design": dataclasses.asdict(fwd),
          "backward_design": dataclasses.asdict(bwd), "fwd_max_abs_err": fwd_err, "saved_rel_err": saved_err, "fwd_tol": tol,
          "grad_rel_err_plain": bwd_err, "grad_max_abs_err_plain": bwd_abs, "tol_plain": BWD_TOL[dtype], "finite": finite})
    where = f"resident_in {(T, B, H, dtype, variant)}"
    check(finite, f"{where}: non-finite outputs or gradients")
    check(torch.equal(out, out2) and torch.equal(state, state2), f"{where}: writing the backward's buffers changed an output")
    check(fwd_err <= tol and saved_err <= tol, f"{where}: forward error {fwd_err}, saved buffers {saved_err} > {tol}")
    check(bwd_err <= BWD_TOL[dtype], f"{where}: backward against the plain recurrence {bwd_err} > {BWD_TOL[dtype]}")
    if variant == "saturated":
        check(bool((proj[:, :quarter][..., gates] < -88).all()) and bool((got[0][:, :quarter][..., gates] == 0).all()),
              f"{where}: a gate below -88 has a gradient")
    if variant == "resets_every_step":
        check(bool((state == 0).all()), f"{where}: a carry survived a reset")
    return fwd_err, (bwd_abs, bwd_err)


def in_gradient_case(torch, cuda_rnn, T, B, H):
    """`lstm_seq_in` at a float32 site as the learner calls it (a gradient into x, wi, bi, hc0 and wh): one launch of each
    fused kernel, no other RNN kernel; outputs within fwd_tol and gradients within GRAD_F32_TOL of autograd through the plain
    version. Returns the gradients' error."""
    args = [a.requires_grad_(i != 4) for i, a in enumerate(in_inputs(torch, T, B, H, "float32", seed=41))]
    wrt = [a for i, a in enumerate(args) if i != 4]
    before = cuda_rnn.launch_counts()
    out, state = cuda_rnn.lstm_seq_in(*args)
    grads = torch.autograd.grad((out**2).sum() + state.sum(), wrt)
    torch.cuda.synchronize()
    after = cuda_rnn.launch_counts()
    check({k: after[k] - before[k] for k in after} == {**dict.fromkeys(after, 0), "lstm_seq_resident_in": 1, "lstm_seq_resident_in_bwd": 1},
          f"lstm_seq_in {(T, B, H)}: launches {after} after {before}")
    ref_out, ref_state = cuda_rnn.lstm_seq_in_reference(*args)
    ref_grads = torch.autograd.grad((ref_out**2).sum() + ref_state.sum(), wrt)
    fwd = max(float((out - ref_out).detach().abs().max()), float((state - ref_state).detach().abs().max()))
    grad = max(rel_err(g, r) for g, r in zip(grads, ref_grads))
    emit({"phase": "parity", "kernel": "lstm_seq_in", "shape": [T, B, H], "input": DMLAB_INSTRUCTION_EMBED, "dtype": "float32",
          "fwd_max_abs_err": fwd, "fwd_tol": fwd_tol("float32", T), "grad_rel_err": grad, "grad_tol": GRAD_F32_TOL})
    check(fwd <= fwd_tol("float32", T) and grad <= GRAD_F32_TOL, f"lstm_seq_in {(T, B, H)}: forward {fwd}, gradients {grad}")
    return grad


def s1_parity_case(torch, cuda_rnn):
    """S1 (ROADMAP C): `lstm_seq` on a contiguous float32 x_proj one float into its buffer at S1_SHAPE, where the grid design
    reads x_proj with 8 x 8 register tiles (float2 loads): the wrapper hands the kernel an aligned copy, and the result is the
    plain version's."""
    T, B, H = S1_SHAPE
    plan = cuda_rnn.launch_plan("lstm", T, B, H, "float32", SPEC)
    check(plan.design == "grid" and (plan.tile_rows, plan.tile_cols) == (8, 8), f"S1: {S1_SHAPE} takes {plan}")
    args = make_inputs(torch, "lstm", T, B, H, "float32", seed=21)
    with torch.no_grad():
        before = cuda_rnn.launch_counts()["lstm_seq_grid"]
        out, state = cuda_rnn.lstm_seq(odd_view(torch, args[0]), *args[1:])
        torch.cuda.synchronize()
        check(cuda_rnn.launch_counts()["lstm_seq_grid"] == before + 1, "S1: lstm_seq_grid was not launched")
        ref_out, ref_state = cuda_rnn.lstm_seq_reference(*args)
    err = max(float((out - ref_out).abs().max()), float((state - ref_state).abs().max()))
    emit({"phase": "parity", "kernel": "lstm_seq_grid", "case": "S1: x_proj one float into its buffer", "shape": [T, B, H],
          "dtype": "float32", "design": dataclasses.asdict(plan), "fwd_max_abs_err": err, "fwd_tol": fwd_tol("float32", T)})
    check(err <= fwd_tol("float32", T), f"S1: error {err} against the plain version")


def backward_pieces(cuda_rnn, kind):
    """(the kernel forward, the backward from the saved tensors, the plain recurrence, the plain forward, the
    backward kernel's launch) of one kind."""
    if kind == "gru":
        return cuda_rnn.gru_seq, cuda_rnn.gru_seq_backward, cuda_rnn.gru_seq_bwd_reference, cuda_rnn.gru_seq_reference, cuda_rnn._launch_gru_bwd
    return cuda_rnn.lstm_seq, cuda_rnn.lstm_seq_backward, cuda_rnn.lstm_seq_bwd_reference, cuda_rnn.lstm_seq_reference, cuda_rnn._launch_lstm_bwd


def backward_inputs(torch, cuda_rnn, kind, T, B, H, dtype, variant=None, seed=0):
    """The inputs, the kernel forward's outputs (no_grad), cotangents of both outputs, and the recurrence's own
    inputs as the prologue makes them. `variant`: "resets_every_step", or "saturated" (the sigmoid gates'
    pre-activations of the first quarter of the rows at -200)."""
    import numpy as np

    forward = backward_pieces(cuda_rnn, kind)[0]
    args = make_inputs(torch, kind, T, B, H, dtype, seed=seed)
    if variant == "resets_every_step":
        args[2].fill_(1.0)
    if variant == "saturated":
        for g in ([0, 1] if kind == "gru" else [0, 1, 3]):
            args[0][:, : B // 4, g * H:(g + 1) * H] = -200.0
    with torch.no_grad():
        out, state = forward(*args)
    rng = np.random.default_rng(seed + 1)
    d_out = torch.tensor(rng.normal(size=tuple(out.shape)).astype(np.float32), device=out.device)
    d_state = torch.tensor(rng.normal(size=tuple(state.shape)).astype(np.float32), device=out.device)
    h_prev = cuda_rnn._carries_in(args[1], args[2], out)
    h_in = h_prev.to(args[0].dtype)
    if kind == "gru":
        recurrence = (d_out, d_state, args[2], args[0], h_in @ args[3] + args[4], h_prev, args[3])
    else:
        recurrence = (d_out, d_state, args[2], args[0] + h_in @ args[3], args[1], args[3])
    return args, out, d_out, d_state, recurrence


def remat_grads(cuda_rnn, kind, args, d_out, d_state):
    """The remat: the plain forward rerun under autograd (`_recompute_grads`, the CPU's backward), the gradients of every
    input but resets."""
    reference = backward_pieces(cuda_rnn, kind)[3]
    grads = cuda_rnn._recompute_grads(reference, args, [i != 2 for i in range(len(args))], (d_out, d_state))
    return [g for g in grads if g is not None]


def bwd_parity_case(torch, cuda_rnn, kind, T, B, H, dtype, variant=None, site=None):
    """The backward with its kernel once against the same prologue and epilogue around the plain recurrence (the
    same saved tensors and cotangents: BWD_TOL), and against the remat (GRAD_F32_TOL, 4 x BF16_TOL in bf16)."""
    _, backward, plain, _, _ = backward_pieces(cuda_rnn, kind)
    args, out, d_out, d_state, _ = backward_inputs(torch, cuda_rnn, kind, T, B, H, dtype, variant, seed=T + B + H + 1)
    plan = cuda_rnn.bwd_plan(kind, B, H, dtype, SPEC)
    name = cuda_rnn._bwd_kernel_name(kind, plan)
    with torch.no_grad():
        before = cuda_rnn.launch_counts()[name]
        got = backward(*args, out, d_out, d_state)
        torch.cuda.synchronize()
        check(cuda_rnn.launch_counts()[name] == before + 1, f"{kind} {(T, B, H)}: {name} was not launched")
        want = backward(*args, out, d_out, d_state, recurrence=plain)
    remat = remat_grads(cuda_rnn, kind, args, d_out, d_state)
    torch.cuda.synchronize()
    err = max(rel_err(g, w) for g, w in zip(got, want))
    abs_err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    err_remat = max(rel_err(g, w) for g, w in zip(got, remat))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    tol, tol_remat = BWD_TOL[dtype], GRAD_F32_TOL if dtype == "float32" else 4 * BF16_TOL
    emit({"phase": "parity", "kernel": name, "shape": [T, B, H], "dtype": dtype, "variant": variant, "site": site,
          "design": dataclasses.asdict(plan), "grad_rel_err_plain": err, "grad_max_abs_err_plain": abs_err, "tol_plain": tol, "grad_rel_err_remat": err_remat, "tol_remat": tol_remat, "finite": finite})
    where = f"{name} {(T, B, H, dtype, variant)}"
    check(finite, f"{where}: non-finite gradients")
    check(err <= tol, f"{where}: against the plain recurrence {err} > {tol}")
    check(err_remat <= tol_remat, f"{where}: against the remat {err_remat} > {tol_remat}")
    if variant == "saturated":
        zero = all(bool((got[0][:, : B // 4, g * H:(g + 1) * H] == 0).all()) for g in ([0, 1] if kind == "gru" else [0, 1, 3]))
        check(zero, f"{where}: a gate below -88 has a gradient")
    return abs_err, err


def bwd_bound(kind, T, B, H, dtype):
    """Least time for the backward kernel's function on an H100: each input (d_outs, the final state's cotangent,
    resets, x_proj or proj, the GRU's h_proj and h_prev or the LSTM's hc0, wh) read once and each output
    (d_x_proj, the GRU's d_hn, the first state's cotangent) written once at 3.35 TB/s, against the
    2*T*B*G*H*H operations of the d_h_proj @ wh^T product at the dtype's peak, as `bound` reckons the forward."""
    G = 3 if kind == "gru" else 4
    item = 2 if dtype == "bfloat16" else 4
    state = H if kind == "gru" else 2 * H
    wide = T * B * G * H * item  # x_proj, the GRU's h_proj, d_x_proj
    nbytes = T * B * H * 4 + B * state * 4 + T * B * 4 + H * G * H * item + B * state * 4
    nbytes += 3 * wide + T * B * H * (item + 4) if kind == "gru" else 2 * wide + B * state * 4
    flops = 2 * T * B * G * H * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def host_ms(torch, fn, reps):
    """Median host-clock ms of fn over `reps` calls after one warm-up, each between two synchronizes."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_bwd(torch, cuda_rnn, card):
    """At each learner site (BWD_SITES): the planned backward kernel alone (CUDA events, warm and L2-cold; at the grid and
    cluster designs' sites in turns with the row design at the same shape: planned, rows, rows, planned; where the other
    count of receive buffers takes other rows, that plan too: planned, rows, other, other, rows, planned), the plain
    recurrence, the kernel's bound, bytes and operations; at the first site of each kernel (BWD_LINE_SITES) also the whole
    new backward (prologue, kernel, epilogue) and the remat (the plain forward rerun under autograd), in turns (new, remat,
    remat, new), in CUDA-event ms and host-clock ms, and each under the profiler (the device's busy ms). Returns the
    kernels line's numbers by site."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    start, out = time.perf_counter(), {}
    for site, (kind, (T, B, H, dtype), path) in BWD_SITES.items():
        _, backward, plain, _, launch = backward_pieces(cuda_rnn, kind)
        args, outs, d_out, d_state, recurrence = backward_inputs(torch, cuda_rnn, kind, T, B, H, dtype, seed=5)
        ways = {"new": lambda: backward(*args, outs, d_out, d_state), "remat": lambda: remat_grads(cuda_rnn, kind, args, d_out, d_state)}
        plan = cuda_rnn.bwd_plan(kind, B, H, dtype, SPEC)
        rows = cuda_rnn.bwd_rows(kind, B, H, dtype, SPEC)
        designs = {"planned": lambda: launch(*recurrence)}
        if plan.design != "rows":
            designs["rows"] = lambda: launch(*recurrence, rows=rows)
        # the other receive-buffer count, where it takes other rows (`selfplay`: two buffers at 16 rows against the plan's one at 32)
        other = cuda_rnn.bwd_cluster_plan(kind, B, H, dtype, SPEC, buffers=3 - plan.buffers) if plan.design == "cluster" else None
        if other is not None and other.rows != plan.rows:
            designs["other_buffers"] = lambda: launch(*recurrence, plan=other)
        kernel = {d: {"warm": [], "l2_cold": []} for d in designs}
        with torch.no_grad():
            for d in [*designs, *reversed(designs)] if len(designs) > 1 else ["planned"]:
                kernel[d]["warm"].append(time_ms(torch, designs[d]))
                kernel[d]["l2_cold"].append(time_ms(torch, designs[d], flush=flush))
            plain_ms = time_ms(torch, lambda: plain(*recurrence), reps=BWD_REPS)
        kernel_ms, kernel_ms_l2_cold = (statistics.median(kernel["planned"][k]) for k in ("warm", "l2_cold"))
        bound_ms, bound_by, nbytes, flops = bwd_bound(kind, T, B, H, dtype)
        row = {"kernel_ms": kernel_ms, "kernel_ms_l2_cold": kernel_ms_l2_cold, "plain_recurrence_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by}
        turns, whole = {w: {"device_ms": [], "host_ms": []} for w in ways}, site in BWD_LINE_SITES.values()
        if whole:
            for w in ("new", "remat", "remat", "new"):
                turns[w]["device_ms"].append(time_ms(torch, ways[w], reps=BWD_REPS))
                turns[w]["host_ms"].append(host_ms(torch, ways[w], BWD_REPS))
            # the second of two profiled calls: a first one has recorded no device activity
            busy = {w: [profiled_device_time(fn) for _ in range(2)][-1][1] / 1e3 for w, fn in ways.items()}
            row.update(whole_ms=statistics.median(turns["new"]["device_ms"]), whole_host_ms=statistics.median(turns["new"]["host_ms"]),
                       remat_ms=statistics.median(turns["remat"]["device_ms"]), remat_host_ms=statistics.median(turns["remat"]["host_ms"]),
                       whole_device_busy_ms=busy["new"], remat_device_busy_ms=busy["remat"],
                       whole_over_remat_host=statistics.median(turns["new"]["host_ms"]) / statistics.median(turns["remat"]["host_ms"]),
                       whole_over_remat_busy=busy["new"] / busy["remat"])
        for d in set(designs) - {"planned"}:
            row.update({f"{d}_kernel_ms": statistics.median(kernel[d]["warm"]), f"{d}_kernel_ms_l2_cold": statistics.median(kernel[d]["l2_cold"])})
        if "other_buffers" in designs:
            row["other_buffers_design"] = dataclasses.asdict(other)
        name = cuda_rnn._bwd_kernel_name(kind, plan)
        emit({"phase": "bwd", "kernel": name, "site": site, "path": path, "shape": [T, B, H], "dtype": dtype,
              "design": dataclasses.asdict(plan), "row_design_rows_a_block": rows, **row, "kernel_turns": kernel, "turns": turns,
              "bytes": nbytes, "flops": flops, "kernel_share_of_bound": bound_ms / kernel_ms,
              "reps": {"kernel": REPS, "whole_and_remat": BWD_REPS},
              "stat": "medians; *_ms: CUDA events (the stream's time, host gaps included), kernel_ms after a ~0.5 ms spin, l2_cold: "
                      "100 MB written before each; kernel_turns: the planned design and, at a grid or cluster site, the row design in "
                      "turns (planned, rows, [other_buffers, other_buffers,] rows, planned); *_host_ms: host clock between synchronizes; "
                      "*_device_busy_ms: torch.profiler, the "
                      "second of two calls; whole and remat in turns (new, remat, remat, new)", "card": card})
        out[site] = {"shape": [T, B, H], "dtype": dtype, "ms": kernel_ms, "ms_l2_cold": kernel_ms_l2_cold, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     **({"whole_backward_ms": row["whole_ms"], "whole_backward_host_ms": row["whole_host_ms"],
                         "whole_backward_device_busy_ms": row["whole_device_busy_ms"], "remat_ms": row["remat_ms"],
                         "remat_host_ms": row["remat_host_ms"], "remat_device_busy_ms": row["remat_device_busy_ms"]} if whole else {}),
                     **({"rows_ms": row["rows_kernel_ms"], "rows_ms_l2_cold": row["rows_kernel_ms_l2_cold"]} if plan.design != "rows" else {}),
                     **({"other_buffers": {"buffers": other.buffers, "rows": other.rows, "ms": row["other_buffers_kernel_ms"]}}
                        if "other_buffers" in designs else {})}
    # the resident backward at the resident sites no learner runs (the rollout's and the last value's shapes run under no_grad;
    # bf16 at 2048 rows), in turns with the row design (resident, rows, rows, resident), warm and L2-cold
    with torch.no_grad():
        for site, (T, B, H, dtype) in RESIDENT_SITES.items():
            if site in BWD_SITES:
                continue
            rec = backward_inputs(torch, cuda_rnn, "lstm", T, B, H, dtype, seed=5)[4]
            itemsize = 2 if dtype == "bfloat16" else 4
            plans = {"resident": cuda_rnn.resident_plan("lstm", B, H, dtype, SPEC, backward=True),
                     "rows": cuda_rnn.bwd_row_plan("lstm", B, H, cuda_rnn.bwd_rows("lstm", B, H, dtype, SPEC), itemsize)}
            turns = {d: {"warm": [], "l2_cold": []} for d in plans}
            for d in ("resident", "rows", "rows", "resident"):
                turns[d]["warm"].append(time_ms(torch, lambda: cuda_rnn._launch_lstm_bwd(*rec, plan=plans[d])))
                turns[d]["l2_cold"].append(time_ms(torch, lambda: cuda_rnn._launch_lstm_bwd(*rec, plan=plans[d]), flush=flush))
            bound_ms, bound_by, nbytes, flops = bwd_bound("lstm", T, B, H, dtype)
            row = {"shape": [T, B, H], "dtype": dtype, "ms": statistics.median(turns["resident"]["warm"]),
                   "ms_l2_cold": statistics.median(turns["resident"]["l2_cold"]), "rows_ms": statistics.median(turns["rows"]["warm"]),
                   "rows_ms_l2_cold": statistics.median(turns["rows"]["l2_cold"]),
                   "plain_ms": time_ms(torch, lambda: cuda_rnn.lstm_seq_bwd_reference(*rec), reps=BWD_REPS), "bound_ms": bound_ms,
                   "bound_by": bound_by}
            emit({"phase": "bwd", "kernel": "lstm_seq_resident_bwd", "site": site, "path": None, **row,
                  "design": dataclasses.asdict(plans["resident"]), "kernel_turns": turns, "bytes": nbytes, "flops": flops,
                  "kernel_share_of_bound": bound_ms / row["ms"], "reps": REPS,
                  "stat": "medians of CUDA-event times; turns: resident, rows, rows, resident; l2_cold: 100 MB written before each",
                  "card": card})
            out[f"resident@{site}"] = row
        # lstm_seq_in's backward kernel on the buffers its forward saved (no cell-state pass) at every resident site, in turns
        # with the resident backward on the same proj (the unfused route's, which runs the pass): in_bwd, resident, resident,
        # in_bwd, warm and L2-cold
        for site, (T, B, H, dtype) in RESIDENT_SITES.items():
            args = in_inputs(torch, T, B, H, dtype, seed=5)
            _, _, proj, cells, _ = cuda_rnn._launch_lstm_in(*args, save=True)
            resets, hc0, wh = args[4], args[3], args[5]
            d_out, d_state = torch.randn(T, B, H, device="cuda"), torch.randn(B, 2 * H, device="cuda")
            plan = cuda_rnn.resident_plan("lstm", B, H, dtype, SPEC, backward=True)
            kernels = {"in_bwd": lambda: cuda_rnn._launch_lstm_in_bwd(d_out, d_state, resets, proj, hc0, wh, cells, plan=plan),
                       "resident_bwd": lambda: cuda_rnn._launch_lstm_bwd(d_out, d_state, resets, proj, hc0, wh, plan=plan)}
            turns = {d: {"warm": [], "l2_cold": []} for d in kernels}
            for d in ("in_bwd", "resident_bwd", "resident_bwd", "in_bwd"):
                turns[d]["warm"].append(time_ms(torch, kernels[d]))
                turns[d]["l2_cold"].append(time_ms(torch, kernels[d], flush=flush))
            bound_ms, bound_by, nbytes, flops = in_bwd_bound(T, B, H, dtype)
            med = {d: {k: statistics.median(v) for k, v in t.items()} for d, t in turns.items()}
            row = {"shape": [T, B, H], "dtype": dtype, "ms": med["in_bwd"]["warm"], "ms_l2_cold": med["in_bwd"]["l2_cold"],
                   "resident_bwd_ms": med["resident_bwd"]["warm"], "resident_bwd_ms_l2_cold": med["resident_bwd"]["l2_cold"],
                   "plain_ms": time_ms(torch, lambda: cuda_rnn.lstm_seq_bwd_reference(d_out, d_state, resets, proj, hc0, wh, cells),
                                       reps=BWD_REPS), "bound_ms": bound_ms, "bound_by": bound_by}
            emit({"phase": "bwd", "kernel": "lstm_seq_resident_in_bwd", "site": site, "path": "dmlab" if site in GRAD_SITES else None,
                  **row, "design": dataclasses.asdict(plan), "kernel_turns": turns, "bytes": nbytes, "flops": flops,
                  "kernel_share_of_bound": bound_ms / row["ms"], "reps": REPS,
                  "stat": "medians of CUDA-event times; turns: in_bwd (the saved cell states), resident_bwd (the same kernel "
                          "recomputing them), resident_bwd, in_bwd; l2_cold: 100 MB written before each", "card": card})
            out[f"resident_in@{site}"] = row
    del flush
    emit({"phase": "bwd", "seconds": time.perf_counter() - start, "card": card})
    return out


@contextlib.contextmanager
def remat_backward(cuda_rnn):
    """The remat for the block: the plain forward rerun under autograd in place of the prologue, the
    backward kernel and the epilogue (swapped in here for the learner's turns; the package has no switch)."""
    gru, lstm = cuda_rnn.gru_seq_backward, cuda_rnn.lstm_seq_backward

    def gru_remat(x_proj, h0, resets, wh, bh, outs, d_outs, d_h_final):
        return remat_grads(cuda_rnn, "gru", (x_proj, h0, resets, wh, bh), d_outs, d_h_final)

    def lstm_remat(x_proj, hc0, resets, wh, outs, d_outs, d_hc_final):
        return remat_grads(cuda_rnn, "lstm", (x_proj, hc0, resets, wh), d_outs, d_hc_final)

    cuda_rnn.gru_seq_backward, cuda_rnn.lstm_seq_backward = gru_remat, lstm_remat
    try:
        yield
    finally:
        cuda_rnn.gru_seq_backward, cuda_rnn.lstm_seq_backward = gru, lstm


@contextlib.contextmanager
def row_backward(cuda_rnn):
    """The backward's row design for the block, wherever the plan would take the grid or cluster design (swapped in
    here for the learner's turns; the package has no switch)."""
    planned = cuda_rnn.bwd_plan

    def rows(kind, B, H, dtype, spec=cuda_rnn.H100_SXM):
        itemsize = 2 if str(dtype).endswith("bfloat16") else 4  # a torch dtype or its name
        return cuda_rnn.bwd_row_plan(kind, B, H, cuda_rnn.bwd_rows(kind, B, H, dtype, spec), itemsize)

    cuda_rnn.bwd_plan = rows
    try:
        yield
    finally:
        cuda_rnn.bwd_plan = planned


def capture_train_steps(runner, captured):
    """Keep the arguments of the quantized learner's last enqueued train step (for `learner_turns`)."""
    q = runner._quantizer
    enqueue = q.enqueue

    def keeping(ts, traj, generator=None):
        captured["args"] = (ts, traj, generator)
        return enqueue(ts, traj, generator)

    q.enqueue = keeping


def learner_turns(torch, cuda_rnn, runner, captured, path, card):
    """The learner's train call (the quantized learner's enqueue and flush) on the run's last trajectory, in turns: the
    planned backward kernel, the row design's, the remat, the remat, the row design's, the planned kernel (host clock,
    synced; launches of each), then one call of each under the profiler (the device's busy ms). A reading, not a claim."""
    q, (ts, traj, generator) = runner._quantizer, captured["args"]

    def call():
        q.enqueue(ts, traj, generator)
        q.flush()

    ways = {"kernel": contextlib.nullcontext, "rows": lambda: row_backward(cuda_rnn), "remat": lambda: remat_backward(cuda_rnn)}
    ms, launches, busy = {way: [] for way in ways}, {}, {}
    for way in list(ways) + list(reversed(ways)):
        with ways[way]():
            torch.cuda.synchronize()
            cuda_rnn.reset_launch_counts()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms[way].append((time.perf_counter() - t0) * 1e3)
            launches[way] = cuda_rnn.launch_counts()
    for way in ways:
        with ways[way]():
            _, device_us, rnn_us, _, _ = profiled_device_time(call)
        busy[way] = {"device_busy_ms": device_us / 1e3, "rnn_kernel_ms": rnn_us / 1e3}
    bwd = [k for k in launches["kernel"] if k.endswith("_bwd")]
    rows = [k for k in bwd if k.endswith("_seq_bwd")]
    check(sum(launches["kernel"][k] for k in bwd) == forward_launches(launches["kernel"]) > 0 and not any(launches["remat"][k] for k in bwd),
          f"{path} learner turns: launches {launches}")
    check(sum(launches["rows"][k] for k in rows) == sum(launches["rows"][k] for k in bwd) == forward_launches(launches["rows"]),
          f"{path} learner turns: the row design's launches {launches['rows']}")
    median = {way: statistics.median(v) for way, v in ms.items()}
    emit({"phase": "learner_turns", "path": path, "minibatches": q.num_minibatches, "train_call_ms": ms, "launches": launches,
          "profiled": busy, "kernel_over_remat_host": median["kernel"] / median["remat"], "kernel_over_rows_host": median["kernel"] / median["rows"],
          "stat": "host clock between synchronizes, in turns (kernel, rows, remat, remat, rows, kernel); one call of each under torch.profiler",
          "card": card})


def time_ms(torch, fn, reps=REPS, flush=None, spin=SPIN_CYCLES):
    """Median of `reps` CUDA-event timings of fn after 3 warm-up calls; with `flush` (a tensor
    of L2_FLUSH_BYTES), the L2 cache is overwritten before each timed call. Before the start
    event the card spins for `spin` cycles (~0.5 ms by default), so that the host has enqueued fn's
    kernels by the time the event is reached: the interval is the device's time, not the host's
    launch cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.fill_(1.0)
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(kind, T, B, H, dtype):
    """Least time for the function on an H100: each input read once, each output written
    once, against the products' operations at the peak rate of their type."""
    G = 3 if kind == "gru" else 4
    item = 2 if dtype == "bfloat16" else 4
    state = H if kind == "gru" else 2 * H
    nbytes = T * B * G * H * item + B * state * 4 + T * B * 4 + H * G * H * item + T * B * H * 4 + B * state * 4
    if kind == "gru":
        nbytes += G * H * item
    flops = 2 * T * B * H * G * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def in_bound(T, B, H, I, dtype, saving=False):
    """Least time for lstm_seq_in's forward on an H100: x (in place of x_proj), wi, bi, wh, hc0 and resets read once, outs and
    hc_final written once, and where the backward's buffers are written (saving) proj, the cell states and xh too, against
    the 2*T*B*(I+H)*4H operations of its two products at the dtype's peak."""
    import sample_factory_tpu_torch.ops.cuda_rnn as cuda_rnn

    item = 2 if dtype == "bfloat16" else 4
    G = 4 * H
    nbytes = T * B * I * item + (I + H + 1) * G * item + 2 * B * 2 * H * 4 + T * B * 4 + T * B * H * 4
    if saving:
        nbytes += T * B * G * item + T * B * H * 4 + T * B * cuda_rnn.in_width(I, H) * item
    flops = 2 * T * B * (I + H) * G
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def in_bwd_bound(T, B, H, dtype):
    """Least time for lstm_seq_in's backward kernel on an H100: d_outs, the final state's cotangent, resets, proj, hc0, wh (f32)
    and the saved cell states read once, d_proj and d_hc0 written once, against the 2*T*B*4H*H operations of dg @ wh^T."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = 2 * T * B * H * 4 + 3 * B * 2 * H * 4 + T * B * 4 + 2 * T * B * 4 * H * item + H * 4 * H * 4
    flops = 2 * T * B * 4 * H * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def phase_plans(torch, cuda_rnn, card):
    """The plans made for the SMALLER_CARDS at the grid sites (PARITY_PATH_SHAPES) and the cluster sites
    (CLUSTER_SITES), launched on this card: each against the plain version at the parity phase's forward
    tolerance, and timed warm in turns with this card's own plan (`rnn_seq_turns.against_spec`); then the backward's
    cluster plans at its sites (BWD_SITES) against the plain recurrence at BWD_TOL, timed in turns with this card's."""
    from sample_factory_tpu_torch.ops.rnn_seq_turns import ROUNDS, REPS as TURN_REPS, against_spec

    start = time.perf_counter()
    sites = [(kind, T, B, H, dtype) for kind, T, B, H, dtype, design, _ in PARITY_PATH_SHAPES if design == "grid"]
    sites += [(kind, *shape) for kind, shape in CLUSTER_SITES.values()]
    for sms, clusters_of_8, clusters_of_16 in SMALLER_CARDS:
        spec = cuda_rnn.CardSpec(sms, clusters_of_8, clusters_of_16, SPEC.smem_limit)
        for r in against_spec(spec, sites):
            T, dtype = r["shape"][0], r["dtype"]
            emit({"phase": "plans", "kernel": r["kernel"], "shape": r["shape"], "dtype": dtype, "spec": r["spec"],
                  "design": r["design"], "blocks": r["blocks"], "threads": r["threads"], "smem": r["smem"], "plan": r["plan"],
                  "max_abs_err": r["max_abs_err"], "tol": fwd_tol(dtype, T), "ms": r["ms"], "own_ms": r["own_ms"],
                  "own_plan": r["own_plan"], "same_plan": r["same_plan"], "ms_over_own": r["ms"] / r["own_ms"],
                  "stat": f"median of {ROUNDS} x {TURN_REPS} CUDA-event times of one warm launch, the two plans in turns", "card": card})
            where = f"{r['kernel']} {r['shape']} {dtype} at {sms} SMs"
            check(r["max_abs_err"] <= fwd_tol(dtype, T), f"{where}: error {r['max_abs_err']} against the plain version")
            check(r["design"] != "grid" or r["blocks"] <= sms, f"{where}: {r['blocks']} blocks")
            check(r["design"] != "cluster" or spec.clusters_at_once(r["plan"]["cluster"]) >= 1, f"{where}: {r['plan']}")
        # the backward's cluster plans at its sites: against the plain recurrence, and timed warm in turns with this card's
        # own plan (the card's, then the smaller card's: own, other, other, own)
        for site, (kind, (T, B, H, dtype), _) in BWD_SITES.items():
            plan, own = cuda_rnn.bwd_plan(kind, B, H, dtype, spec), cuda_rnn.bwd_plan(kind, B, H, dtype, SPEC)
            if plan.design != "cluster":
                continue
            _, _, plain, _, launch = backward_pieces(cuda_rnn, kind)
            rec = backward_inputs(torch, cuda_rnn, kind, T, B, H, dtype, seed=6)[4]
            with torch.no_grad():
                got = launch(*rec, plan=plan)
                torch.cuda.synchronize()
                err = max(rel_err(g, w) for g, w in zip(got, plain(*rec)))
                ms = {"other": [], "own": []}
                for way in ("own", "other", "other", "own"):
                    ms[way].append(time_ms(torch, lambda: launch(*rec, plan=plan if way == "other" else own)))
            other_ms, own_ms = statistics.median(ms["other"]), statistics.median(ms["own"])
            emit({"phase": "plans", "kernel": cuda_rnn._bwd_kernel_name(kind, plan), "site": site, "shape": [T, B, H], "dtype": dtype,
                  "spec": dataclasses.asdict(spec), "plan": dataclasses.asdict(plan), "grad_rel_err_plain": err, "tol": BWD_TOL[dtype],
                  "ms": other_ms, "own_ms": own_ms, "own_plan": dataclasses.asdict(own), "same_plan": plan == own,
                  "ms_over_own": other_ms / own_ms, "stat": f"median of 2 x {REPS} CUDA-event times of one warm launch, in turns", "card": card})
            check(err <= BWD_TOL[dtype], f"{site} backward at {sms} SMs: error {err} against the plain recurrence")
            check(spec.clusters_at_once(plan.cluster) >= 1, f"{site} backward at {sms} SMs: {plan}")
    emit({"phase": "plans", "seconds": time.perf_counter() - start, "card": card})


def phase_timing(torch, cuda_rnn, card):
    launches = {"gru": cuda_rnn._launch_gru, "lstm": cuda_rnn._launch_lstm}
    plains = {"gru": cuda_rnn.gru_seq_reference, "lstm": cuda_rnn.lstm_seq_reference}
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    rows_by_shape = {}
    with torch.no_grad():
        # the main-path rows (and the selfplay, doom, dmlab, nethack, isaacgym, tp and defaults paths' shapes):
        # the planned design and the first design (rows) at the same shape, in turns, warm and L2-cold, the
        # plain version and the bound; where the plan takes the row design over a cluster plan of several
        # waves, that cluster plan too
        shapes = [("gru", MAIN_GRU), ("lstm", MAIN_LSTM), ("gru", SELFPLAY_GRU)] + [(k, (T, B, H, dt)) for k, T, B, H, dt, _, _ in PARITY_PATH_SHAPES]
        for kind, (T, B, H, dtype) in shapes:
            args = make_inputs(torch, kind, T, B, H, dtype, seed=2)
            plan = cuda_rnn.launch_plan(kind, T, B, H, dtype, SPEC)
            rows = cuda_rnn.row_plan(kind, B, H)
            row = {"ms": time_ms(torch, lambda: launches[kind](*args)),
                   "rows_ms": time_ms(torch, lambda: launches[kind](*args, plan=rows)),
                   "plain_ms": time_ms(torch, lambda: plains[kind](*args)),
                   "rows_ms_l2_cold": time_ms(torch, lambda: launches[kind](*args, plan=rows), flush=flush),
                   "ms_l2_cold": time_ms(torch, lambda: launches[kind](*args), flush=flush)}
            over = cuda_rnn.cluster_plan(kind, B, H, dtype, SPEC)
            if plan.design in ("rows", "resident") and over is not None:
                row.update(cluster_ms=time_ms(torch, lambda: launches[kind](*args, plan=over)), cluster_waves=cuda_rnn.cluster_waves(over, SPEC))
            bound_ms, bound_by, nbytes, flops = bound(kind, T, B, H, dtype)
            row.update(bound_ms=bound_ms, bound_by=bound_by, design=dataclasses.asdict(plan))
            rows_by_shape[(kind, T, B, H, dtype)] = row
            emit({"phase": "timing", "kernel": f"{kind}_seq", "shape": [T, B, H], "dtype": dtype, **row, "bytes": nbytes, "flops": flops,
                  "reps": REPS, "stat": "median of CUDA-event times; ms: L2 not flushed, l2_cold: 100 MB written before each; "
                                        "rows: the first design (row design) at the same shape", "card": card})
        # each kernel in both dtypes at the GRU's main shape, warm and L2-cold, beside the row design
        T, B, H = MAIN_GRU[:3]
        for kind in ("gru", "lstm"):
            for dtype in ("bfloat16", "float32"):
                args = make_inputs(torch, kind, T, B, H, dtype, seed=3)
                rows = cuda_rnn.row_plan(kind, B, H)
                row = {"phase": "timing", "kernel": f"{kind}_seq", "shape": [T, B, H], "dtype": dtype,
                       "design": dataclasses.asdict(cuda_rnn.launch_plan(kind, T, B, H, dtype, SPEC))}
                for label, flush_with in (("warm", None), ("l2_cold", flush)):
                    row[f"ms_{label}"] = time_ms(torch, lambda: launches[kind](*args), flush=flush_with)
                    row[f"rows_ms_{label}"] = time_ms(torch, lambda: launches[kind](*args, plan=rows), flush=flush_with)
                row["bound_ms"], row["bound_by"] = bound(kind, T, B, H, dtype)[:2]
                emit({**row, "reps": REPS, "stat": "median of CUDA-event times; l2_cold: 100 MB written before each",
                      "card": card})
        # a yardstick of another function: cuDNN's GRU also computes the input product and has
        # no resets; the port never calls it
        gru = torch.nn.GRU(H, H).cuda().to(torch.bfloat16)
        gru.flatten_parameters()
        x = torch.randn(T, B, H, device="cuda", dtype=torch.bfloat16)
        h0 = torch.zeros(1, B, H, device="cuda", dtype=torch.bfloat16)
        emit({"phase": "timing", "yardstick": "torch.nn.GRU (cuDNN), a different function: input product included, "
              "no resets", "shape": [T, B, H], "dtype": "bfloat16",
              "ms_warm": time_ms(torch, lambda: gru(x, h0)), "ms_l2_cold": time_ms(torch, lambda: gru(x, h0), flush=flush),
              "reps": REPS, "card": card})
        resident = resident_timing(torch, cuda_rnn, flush, card)
        route_profile(torch, cuda_rnn, card)
    del flush
    # for the kernels line: each design at the shape of the first path that runs it (the cluster and
    # grid designs' rows carry the row design's time there as `first_design_ms`)
    out = {}
    for name, (kind, shape) in KERNEL_LINE_SHAPES.items():
        row = rows_by_shape[(kind, *shape)]
        ms = row["rows_ms"] if name.endswith("_rows") else row["ms"]
        out[name] = {"ms": ms, "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                     "shape": list(shape[:3]), "dtype": shape[3]}
        if not name.endswith("_rows"):
            out[name].update(ms_l2_cold=row["ms_l2_cold"], design=row["design"], first_design_ms=row["rows_ms"])
    for site, (kind, shape, _) in GRID_SITES.items():
        row = rows_by_shape[(kind, *shape)]
        out[f"{kind}_seq_grid@{site}"] = {"shape": list(shape[:3]), "dtype": shape[3], "ms": row["ms"], "ms_l2_cold": row["ms_l2_cold"],
                                          "rows_ms": row["rows_ms"], "rows_ms_l2_cold": row["rows_ms_l2_cold"],
                                          "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"]}
    out.update(resident)
    return out


def route_ways(torch, cuda_rnn, T, B, H, seed=8):
    """DMLab's instruction encoder at one site, three ways on the same inputs: an embedding [T, B, 20] (DMLAB_INSTRUCTION_EMBED)
    from a zero state, the weights wi, bi, wh. "fused": the port's route, `lstm_seq_in` (one kernel forward; the resident
    backward on the buffers the forward saved, then one product for the weights and one for the embedding); "unfused": the
    route with the input product outside the kernel, the Linear that makes x_proj, then `lstm_seq`; "cudnn": cuDNN's
    torch.nn.LSTM(DMLAB_INSTRUCTION_EMBED, H) (TF32 off; the forget gate's +1 folded into bias_ih), a library call the port
    never makes. Returns {way: (forward, backward)} (a forward runs in the caller's grad mode; a backward: of the outputs and
    the final state into the embedding and every weight, on a graph built once) and the largest differences of cuDNN's and
    the fused route's outputs and gradients from the plain version's."""
    import numpy as np

    rng = np.random.default_rng(seed)
    E, G = DMLAB_INSTRUCTION_EMBED, 4 * H
    emb = torch.tensor(rng.normal(size=(T, B, E)).astype(np.float32), device="cuda", requires_grad=True)
    wi = torch.tensor((rng.normal(size=(E, G)) / math.sqrt(E)).astype(np.float32), device="cuda", requires_grad=True)
    bi = torch.tensor((rng.normal(size=(G,)) * 0.1).astype(np.float32), device="cuda", requires_grad=True)
    wh = torch.tensor((rng.normal(size=(H, G)) / math.sqrt(H)).astype(np.float32), device="cuda", requires_grad=True)
    hc0, resets = torch.zeros(B, 2 * H, device="cuda"), torch.zeros(T, B, device="cuda")
    lstm = torch.nn.LSTM(E, H).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wi.t())
        lstm.weight_hh_l0.copy_(wh.t())
        lstm.bias_ih_l0.copy_(bi + torch.cat([torch.zeros(H), torch.ones(H), torch.zeros(2 * H)]).cuda())
        lstm.bias_hh_l0.zero_()
    lstm.flatten_parameters()
    d_out = torch.tensor(rng.normal(size=(T, B, H)).astype(np.float32), device="cuda")
    d_state = torch.tensor(rng.normal(size=(B, 2 * H)).astype(np.float32), device="cuda")

    def cudnn():
        out, (h, c) = lstm(emb)
        return out, torch.cat([h[0], c[0]], dim=-1)

    forwards = {"unfused": lambda: cuda_rnn.lstm_seq(emb @ wi + bi, hc0, resets, wh), "cudnn": cudnn}
    if hasattr(cuda_rnn, "lstm_seq_in"):
        forwards = {"fused": lambda: cuda_rnn.lstm_seq_in(emb, wi, bi, hc0, resets, wh), **forwards}
    weights = {"cudnn": list(lstm.parameters())}
    graphs = {way: fn() for way, fn in forwards.items()}

    def backward(way):
        out, state = graphs[way]
        return torch.autograd.grad((out, state), [emb, *weights.get(way, [wi, bi, wh])], (d_out, d_state), retain_graph=True)

    ref_out, ref_state = cuda_rnn.lstm_seq_reference(emb @ wi + bi, hc0, resets, wh)
    ref_grads = torch.autograd.grad((ref_out, ref_state), [emb, wi, bi, wh], (d_out, d_state))
    err = {}
    for way in graphs:
        if way == "unfused":
            continue
        out, state = graphs[way]
        grads = backward(way)
        if way == "cudnn":
            g_emb, g_ih, g_hh, g_bih, _ = grads
            grads = (g_emb, g_ih.t(), g_bih, g_hh.t())
        err[way] = {"fwd_max_abs_err": max(float((out - ref_out).abs().max()), float((state - ref_state).abs().max())),
                    "grad_rel_err": max(rel_err(g, r) for g, r in zip(grads, ref_grads))}
    ways = {way: (fn, lambda way=way: backward(way)) for way, fn in forwards.items()}
    return ways, err


# the instruction encoder's sites under no_grad (the rollout and the last-value pass) and with a gradient (the learner)
GRAD_SITES = {"dmlab_instruction_learner"}
ROUTE_PROFILE_REPS = 10


def route_profile(torch, cuda_rnn, card):
    """Every device activity of each route of DMLab's instruction encoder (`route_ways`) at its float32 sites, forward in the
    site's grad mode and, at the learner's minibatch, backward: ROUTE_PROFILE_REPS calls under torch.profiler (device
    activities only) after one warm call, each activity's launches and device us a call. Returns them by site, way and
    direction."""
    start, out = time.perf_counter(), {}
    for site, (T, B, H, dtype) in RESIDENT_SITES.items():
        if dtype != "float32":
            continue
        with torch.enable_grad():
            ways, _ = route_ways(torch, cuda_rnn, T, B, H)
        grad = site in GRAD_SITES
        for way, (forward, backward) in ways.items():
            for direction, fn in [("forward", forward)] + ([("backward", backward)] if grad else []):
                def calls(fn=fn, direction=direction):
                    with torch.enable_grad() if grad or direction == "backward" else torch.no_grad():
                        for _ in range(ROUTE_PROFILE_REPS):
                            fn()
                with torch.enable_grad() if grad else torch.no_grad():
                    fn()
                torch.cuda.synchronize()
                _, busy_us, _, events, _ = profiled_device_time(calls)
                activities = {}
                for e in events:
                    name = e.name[:90]
                    n, us = activities.get(name, (0, 0.0))
                    activities[name] = (n + 1, us + e.time_range.elapsed_us())
                row = {"launches_per_call": len(events) / ROUTE_PROFILE_REPS, "device_us_per_call": busy_us / ROUTE_PROFILE_REPS,
                       "activities": [{"name": name, "launches": n / ROUTE_PROFILE_REPS, "us": us / ROUTE_PROFILE_REPS}
                                      for name, (n, us) in sorted(activities.items(), key=lambda kv: -kv[1][1])]}
                out[f"{site}/{way}/{direction}"] = row
                emit({"phase": "route_profile", "site": site, "shape": [T, B, H], "dtype": dtype, "way": way, "direction": direction,
                      "grad": grad, **row, "reps": ROUTE_PROFILE_REPS,
                      "stat": "torch.profiler, device activities only, over reps calls after one warm call; per call", "card": card})
    emit({"phase": "route_profile", "seconds": time.perf_counter() - start, "card": card})
    return out


def resident_timing(torch, cuda_rnn, flush, card):
    """At RESIDENT_SITES: the resident design in turns with the row design and the cluster plan where there is one (resident,
    rows, cluster, cluster, rows, resident), each warm and L2-cold, the plain version and the bound; lstm_seq_in's kernel (with
    the backward's buffers at the learner's site) in turns with the unfused route, the Linear + the resident kernel (fused,
    unfused, unfused, fused), warm and L2-cold, its plain version and bound; at the float32 sites the instruction encoder's three
    routes (`route_ways`: fused, unfused, cuDNN) in turns, forward in the site's grad mode and backward, warm. Returns the kernels
    line's numbers: `lstm_seq_resident@<site>`, `lstm_seq_resident_in@<site>`, and the learner's as `lstm_seq_resident` and
    `lstm_seq_resident_in`."""
    out = {}
    with torch.no_grad():
        for site, (T, B, H, dtype) in RESIDENT_SITES.items():
            args = make_inputs(torch, "lstm", T, B, H, dtype, seed=4)
            plans = {"resident": cuda_rnn.resident_plan("lstm", B, H, dtype, SPEC), "rows": cuda_rnn.row_plan("lstm", B, H)}
            over = cuda_rnn.cluster_plan("lstm", B, H, dtype, SPEC)
            if over is not None:
                plans["cluster"] = over
            turns = {d: {"warm": [], "l2_cold": []} for d in plans}
            for d in [*plans, *reversed(plans)]:
                turns[d]["warm"].append(time_ms(torch, lambda: cuda_rnn._launch_lstm(*args, plan=plans[d])))
                turns[d]["l2_cold"].append(time_ms(torch, lambda: cuda_rnn._launch_lstm(*args, plan=plans[d]), flush=flush))
            med = {d: {k: statistics.median(v) for k, v in t.items()} for d, t in turns.items()}
            bound_ms, bound_by, nbytes, flops = bound("lstm", T, B, H, dtype)
            row = {"shape": [T, B, H], "dtype": dtype, "ms": med["resident"]["warm"], "ms_l2_cold": med["resident"]["l2_cold"],
                   "rows_ms": med["rows"]["warm"], "rows_ms_l2_cold": med["rows"]["l2_cold"],
                   "plain_ms": time_ms(torch, lambda: cuda_rnn.lstm_seq_reference(*args), reps=BWD_REPS), "bound_ms": bound_ms,
                   "bound_by": bound_by, "planned": cuda_rnn.launch_plan("lstm", T, B, H, dtype, SPEC).design, "library_ms": None}
            if over is not None:
                row.update(cluster_ms=med["cluster"]["warm"], cluster_ms_l2_cold=med["cluster"]["l2_cold"],
                           cluster_waves=cuda_rnn.cluster_waves(over, SPEC))
            # lstm_seq_in's kernel (with the backward's buffers where the site needs a gradient) in turns with the unfused
            # route (the Linear, then the resident kernel): fused, unfused, unfused, fused, warm and L2-cold
            saving = site in GRAD_SITES
            iargs = in_inputs(torch, T, B, H, dtype, seed=4)
            fused_plan = cuda_rnn.resident_in_plan(T, B, H, DMLAB_INSTRUCTION_EMBED, getattr(torch, dtype), SPEC)
            routes = {"fused": lambda: cuda_rnn._launch_lstm_in(*iargs, save=saving, plan=fused_plan),
                      "unfused": lambda: cuda_rnn._launch_lstm((iargs[0] @ iargs[1] + iargs[2]).contiguous(), *iargs[3:])}
            in_turns = {d: {"warm": [], "l2_cold": []} for d in routes}
            for d in ("fused", "unfused", "unfused", "fused"):
                in_turns[d]["warm"].append(time_ms(torch, routes[d]))
                in_turns[d]["l2_cold"].append(time_ms(torch, routes[d], flush=flush))
            in_med = {d: {k: statistics.median(v) for k, v in t.items()} for d, t in in_turns.items()}
            in_row = {"shape": [T, B, H], "input": DMLAB_INSTRUCTION_EMBED, "dtype": dtype, "saving": saving,
                      "ms": in_med["fused"]["warm"], "ms_l2_cold": in_med["fused"]["l2_cold"],
                      "unfused_route_ms": in_med["unfused"]["warm"], "unfused_route_ms_l2_cold": in_med["unfused"]["l2_cold"],
                      "plain_ms": time_ms(torch, lambda: cuda_rnn.lstm_seq_in_reference(*iargs), reps=BWD_REPS), "library_ms": None}
            in_row["bound_ms"], in_row["bound_by"], in_bytes, in_flops = in_bound(T, B, H, DMLAB_INSTRUCTION_EMBED, dtype, saving)
            library = {}
            if dtype == "float32":
                # the routes of the instruction encoder in turns: fused, unfused, cuDNN, cuDNN, unfused, fused; the forward in
                # the site's grad mode, the backward on a graph built once
                with torch.enable_grad():
                    ways, err = route_ways(torch, cuda_rnn, T, B, H)
                    ms = {f"{w}_{p}": [] for w in ways for p in ("fwd", "bwd")}
                    for w in [*ways, *reversed(ways)]:  # a longer spin: autograd's host work is behind it
                        with torch.enable_grad() if saving else torch.no_grad():
                            ms[f"{w}_fwd"].append(time_ms(torch, ways[w][0], spin=10 * SPIN_CYCLES))
                        ms[f"{w}_bwd"].append(time_ms(torch, ways[w][1], reps=BWD_REPS, spin=10 * SPIN_CYCLES))
                library = {f"{k}_ms": statistics.median(v) for k, v in ms.items()}
                library.update(cudnn_fwd_max_abs_err=err["cudnn"]["fwd_max_abs_err"], cudnn_grad_rel_err=err["cudnn"]["grad_rel_err"],
                               fused_fwd_max_abs_err=err["fused"]["fwd_max_abs_err"], fused_grad_rel_err=err["fused"]["grad_rel_err"])
                row["library_ms"] = in_row["library_ms"] = library["cudnn_fwd_ms"]
                for way in ("cudnn", "fused"):
                    check(err[way]["fwd_max_abs_err"] <= fwd_tol(dtype, T) and err[way]["grad_rel_err"] <= GRAD_F32_TOL,
                          f"the {way} route at {site} disagrees with the plain version: {err[way]}")
            emit({"phase": "timing", "kernel": "lstm_seq_resident", "site": site, **row, "design": dataclasses.asdict(plans["resident"]),
                  "turns": turns, "cudnn": library, "bytes": nbytes, "flops": flops, "kernel_share_of_bound": bound_ms / row["ms"],
                  "reps": REPS, "stat": "medians of CUDA-event times; turns: resident, rows[, cluster, cluster], rows, resident; "
                                        "l2_cold: 100 MB written before each; cudnn: torch.nn.LSTM(20, 64) with TF32 off against "
                                        "the fused route (lstm_seq_in) and the unfused route (the Linear + lstm_seq) (fused, "
                                        "unfused, cudnn, cudnn, unfused, fused), the forward in the site's grad mode, each route's "
                                        "backward of its outputs and final state into the embedding and every weight, after a "
                                        "~5 ms spin",
                  "card": card})
            emit({"phase": "timing", "kernel": "lstm_seq_resident_in", "site": site, **in_row, "design": dataclasses.asdict(fused_plan),
                  "turns": in_turns, "bytes": in_bytes, "flops": in_flops, "kernel_share_of_bound": in_row["bound_ms"] / in_row["ms"],
                  "reps": REPS, "stat": "medians of CUDA-event times; turns: fused (lstm_seq_in's kernel), unfused (the Linear + "
                                        "the resident kernel), unfused, fused; l2_cold: 100 MB written before each", "card": card})
            out[f"lstm_seq_resident@{site}"] = {**row, "cudnn": library}
            out[f"lstm_seq_resident_in@{site}"] = {**in_row, "cudnn": library}
    out["lstm_seq_resident"] = out["lstm_seq_resident@dmlab_instruction_learner"]
    out["lstm_seq_resident_in"] = out["lstm_seq_resident_in@dmlab_instruction_learner"]
    return out


def train(torch, cuda_rnn, argv, train_dir, before_run=None, observers=(), register_fn=None, device_flag=("--device=gpu",), parse=None):
    """Drive `argv` through make_rl_runner / Runner.run, as `run_rl` does, with the kernels'
    launch counts set to 0 just before the run and read just after. `before_run(runner)`
    may instrument the initialised runner; `observers` are registered before its init;
    `register_fn` registers a host env inside its worker processes; `parse` is an example's
    own argument parser (`train_synthetic`'s by default)."""
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.runner.runner import AlgoObserver
    from sample_factory_tpu_torch.train import make_rl_runner

    parse = parse or parse_custom_args

    class IterationClock(AlgoObserver):
        """The host time at the end of each iteration, after a sync."""

        def __init__(self):
            self.times = []

        def on_training_iteration(self, runner, stats):
            torch.cuda.synchronize()
            self.times.append(time.perf_counter())

    _, runner = make_rl_runner(parse(argv + [f"--train_dir={train_dir}", *device_flag, "--seed=0"]), register_fn=register_fn)
    clock = IterationClock()
    runner.register_observer(clock)
    for observer in observers:
        runner.register_observer(observer)
    runner.init()
    if before_run is not None:
        before_run(runner)
    torch.cuda.synchronize()
    cuda_rnn.reset_launch_counts()
    start = time.perf_counter()
    check(runner.run() == 0, "runner.run() failed")
    torch.cuda.synchronize()
    counts = cuda_rnn.launch_counts()
    stats = runner.host_stats()  # one dict, or one per policy from the population runner
    per_policy = stats if isinstance(stats, list) else [stats]
    check(per_policy and all(s and all(math.isfinite(v) for v in s.values()) for s in per_policy), f"non-finite training stats: {stats}")
    exp = os.path.join(train_dir, runner.cfg.experiment)
    check(os.path.isfile(os.path.join(exp, "config.json")), "config.json missing")
    check(os.path.isfile(os.path.join(exp, "done")), "done file missing")
    ckpts = [f for f in os.listdir(os.path.join(exp, "checkpoint_p0")) if f.startswith("checkpoint_")]
    check(len(ckpts) >= 1, "no checkpoint written")
    return runner, counts, stats, [start] + clock.times


QUIET = ["--save_every_sec=100000", "--save_best_every_sec=100000", "--experiment_summaries_interval=100000", "--num_workers=1"]
GRID_BATTLE = [
    "--env=grid_battle", "--use_rnn=True", "--rnn_size=256", "--encoder_conv_mlp_layers", "256",
    "--rollout=32", "--recurrence=32", "--num_epochs=1", "--normalize_input=True",
] + QUIET
COMMON = GRID_BATTLE + ["--async_rl=False", "--encoder_conv_architecture=convnet_impala"]
MAIN_MODEL = ["--rnn_type=gru", "--compute_dtype=bfloat16", "--batch_size=16384"]


def record_rollouts(runner, seen):
    """Wrap the runner's rollout function: note the module and the version each rollout was
    given, and the trajectory's stamps and action tensor."""
    rollout_fn = runner._rollout_fn

    def rollout(model, obs_rms, ss, version, pid):
        out = rollout_fn(model, obs_rms, ss, version, pid)
        traj = out[1]
        seen.append({"model": model, "version": int(version), "train_step": runner.train_state.train_step,
                     "stamp_min": traj["policy_version"].min(), "stamp_max": traj["policy_version"].max(),
                     "actions_shape": tuple(traj["actions"].shape), "actions_dtype": traj["actions"].dtype})
        return out

    runner._rollout_fn = rollout


def timed_iteration(torch, runner):
    """One more iteration of the runner's regime with a sync after each part (host clock):
    rollout, learner and, in the async regime, the refresh of the behaviour snapshot."""
    ts, cfg = runner.train_state, runner.cfg
    model, version = (runner.behavior_model, runner.behavior_version) if cfg.async_rl else (ts.model, ts.train_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.sampler_state, traj, _ = runner._rollout_fn(model, ts.obs_rms, runner.sampler_state, version, runner.policy_id)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    runner._train_fn(ts, traj, runner.train_generator)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = {"rollout_ms": (t1 - t0) * 1e3, "train_ms": (t2 - t1) * 1e3}
    if cfg.async_rl:
        with torch.no_grad():
            torch._foreach_copy_(list(runner.behavior_model.parameters()), list(ts.model.parameters()))
        runner.behavior_version = ts.train_step
        torch.cuda.synchronize()
        out["snapshot_copy_ms"] = (time.perf_counter() - t2) * 1e3
    out["env_steps_per_s"] = cfg.num_envs * cfg.rollout / (time.perf_counter() - t0)
    return out


def phase_main(torch, cuda_rnn, card, tmp):
    iters, envs = 3, 1024
    argv = COMMON + MAIN_MODEL + [f"--num_envs={envs}", f"--train_for_env_steps={iters * envs * 32}", "--experiment=grid_battle_gru"]
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp)
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == iters, f"expected {iters} iterations, ran {len(per_iter)}")
    check(counts["gru_seq"] == 2 * iters, f"GRU kernel launches {counts['gru_seq']}, expected {2 * iters}")
    check(counts["lstm_seq"] == 0, "LSTM kernel launched on the GRU path")
    check_backward_launches(counts, "main")
    steady = per_iter[1:]
    steady_rate = envs * 32 * len(steady) / sum(steady)
    emit({"phase": "main", "env": "grid_battle", "envs": envs, "rollout": 32, "iterations": iters,
          "env_steps": runner.env_steps, "launches": counts, "iteration_s": per_iter,
          "env_steps_per_s_steady": steady_rate,
          "env_steps_per_s_all": runner.env_steps / sum(per_iter),
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    return runner, counts, steady_rate


def device_share(torch, fn, unprofiled_s):
    """The device's busy time in one call of fn under the profiler, against an unprofiled
    iteration of `unprofiled_s` seconds: the profiler slows the host, not the device."""
    _, device_us, rnn_us, on_device, _ = profiled_device_time(fn)
    return {"device_busy_ms": device_us / 1e3, "device_activities": len(on_device), "rnn_kernel_ms": rnn_us / 1e3,
            "rnn_kernel_share_of_device": rnn_us / device_us, "device_idle_share_unprofiled": 1.0 - device_us / (unprofiled_s * 1e6)}


def phase_breakdown(torch, runner, card):
    """Where an iteration's time goes: rollout vs learner (host clock, synced), then
    the device's busy time under torch.profiler (sum of kernel times / wall time)."""
    ts = runner.train_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ss, traj, _ = runner._rollout_fn(ts.model, ts.obs_rms, runner.sampler_state, ts.train_step, runner.policy_id)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    runner._train_fn(ts, traj, runner.train_generator)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    runner.sampler_state = ss

    wall_us, device_us, rnn_us, on_device, by_name = profiled_device_time(runner.train_iteration_sync)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "breakdown", "rollout_ms": (t1 - t0) * 1e3, "train_ms": (t2 - t1) * 1e3,
          "profiled_iteration_ms": wall_us / 1e3, "device_busy_ms": device_us / 1e3,
          "device_idle_share_profiled": 1.0 - device_us / wall_us,
          "device_idle_share_unprofiled": 1.0 - device_us / ((t2 - t0) * 1e6),
          "device_activities": len(on_device), "rnn_kernel_ms": rnn_us / 1e3,
          "rnn_kernel_share_of_device": rnn_us / device_us, "top_device_ms": {k: v / 1e3 for k, v in top}, "card": card})


def phase_lstm(torch, cuda_rnn, card, tmp):
    envs = 128
    argv = COMMON + ["--rnn_type=lstm", "--compute_dtype=float32", "--batch_size=4096", f"--num_envs={envs}",
                     f"--train_for_env_steps={envs * 32}", "--experiment=grid_battle_lstm"]
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp)
    check(counts["lstm_seq"] >= 1 and counts["gru_seq"] == 0, f"LSTM path launches {counts}")
    check_backward_launches(counts, "lstm")

    # the trained model on the card against the same model on the CPU (plain versions)
    import copy

    import numpy as np

    model = runner.train_state.model
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.default_rng(3)
    S, R = 4, 32
    obs = torch.tensor(rng.random((S, R, 24, 24, 3)).astype(np.float32))
    rnn = torch.tensor((rng.normal(size=(S, 512)) * 0.5).astype(np.float32))
    resets = torch.tensor((rng.random((R, S)) < 0.1).astype(np.float32))

    def forward(m, device):
        head = m.forward_head({"obs": obs.to(device)})
        outs, final = m.forward_core_seq(head.transpose(0, 1), rnn.to(device), resets.to(device))
        logits, values = m.forward_tail(outs.transpose(0, 1).reshape(S * R, -1))
        return logits, values, final

    with torch.no_grad():
        before = cuda_rnn.launch_counts()["lstm_seq"]
        on_card = forward(model, "cuda")
        torch.cuda.synchronize()
        check(cuda_rnn.launch_counts()["lstm_seq"] == before + 1, "model check did not run the LSTM kernel")
        on_cpu = forward(cpu_model, "cpu")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(on_card, on_cpu))
    tol = 1e-3  # float32 with TF32 off; convolution and matmul sums run in other orders on the two devices
    emit({"phase": "lstm", "envs": envs, "env_steps": runner.env_steps, "launches": counts,
          "iteration_s": [b - a for a, b in zip(times, times[1:])], "loss": stats["loss"],
          "model_card_vs_cpu_max_abs_err": err, "tol": tol, "card": card})
    check(all(bool(torch.isfinite(t).all()) for t in on_card), "non-finite model outputs")
    check(err <= tol, f"model on the card vs the CPU: {err} > {tol}")
    return counts


def median_split(splits):
    return {k: statistics.median(s[k] for s in splits) for k in splits[0]}


def advantage_loops_ms(torch, envs, segments, T=32, reps=10):
    """Host-clock time (synced, median) of the two reverse-time loops at the main path's
    sizes: V-trace on one minibatch [T, segments], which the async V-trace learner runs per
    minibatch, and GAE on the whole rollout [T, envs], which it skips."""
    from sample_factory_tpu_torch.algo.advantages import gae_advantages, vtrace

    def rand(*shape):
        return torch.rand(shape, device="cuda")

    def timed(fn):
        times = []
        for _ in range(reps + 2):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        return statistics.median(times[2:])

    r, d, v, ratio = rand(T, segments), (rand(T, segments) < 0.05).float(), rand(T, segments), rand(T, segments) + 0.5
    gr, gd, gv, valids = rand(T, envs), (rand(T, envs) < 0.05).float(), rand(T + 1, envs), torch.ones(T + 1, envs, device="cuda")
    return {"vtrace_loop_ms_per_minibatch": timed(lambda: vtrace(r, d, v, ratio, 0.99, 1.0, 1.0)),
            "gae_loop_ms_per_rollout": timed(lambda: gae_advantages(gr, gd, gv, valids, 0.99, 0.95))}


def phase_appo(torch, cuda_rnn, card, tmp, sync_runner, sync_rate):
    """The default regime: no --async_rl flag, V-trace. The rollout of iteration k runs the
    behaviour module at the version from before train call k; each train call takes 2 SGD
    steps, so the learner sees a lag of 2 and never 0. Then the two regimes in turns
    (sync, async, async, sync, three times): the host's clock drifts by tens of percent
    within a run, so only iterations taken side by side compare."""
    iters, envs, sgd_steps = 3, 1024, 2
    argv = GRID_BATTLE + MAIN_MODEL + ["--encoder_conv_architecture=convnet_impala", "--with_vtrace=True", f"--num_envs={envs}",
                                      f"--train_for_env_steps={iters * envs * 32}", "--experiment=grid_battle_appo"]
    seen, lags = [], []

    def before_run(runner):
        from sample_factory_tpu_torch.runner.runner import AlgoObserver

        class Lag(AlgoObserver):
            def on_training_iteration(self, runner, stats):
                lags.append(float(stats["version_diff_max"]))

        check(runner.cfg.async_rl and runner.cfg.with_vtrace and not runner.cfg.normalize_returns, "not the async V-trace regime")
        check(runner.behavior_model is not None and runner.behavior_model is not runner.train_state.model, "no behaviour snapshot")
        record_rollouts(runner, seen)
        runner.register_observer(Lag())

    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, before_run)
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == iters, f"expected {iters} iterations, ran {len(per_iter)}")
    check(counts["gru_seq"] == 2 * iters, f"GRU kernel launches {counts['gru_seq']}, expected {2 * iters}")
    check(not any(others(counts, "gru_seq").values()), f"other kernels launched on the GRU path: {counts}")
    check_backward_launches(counts, "appo")
    live = list(runner.train_state.model.parameters())
    snapshot = list(runner.behavior_model.parameters())
    check(all(a.data_ptr() != b.data_ptr() for a, b in zip(live, snapshot)), "the snapshot shares storage with the trained model")
    check(all(bool(torch.equal(a, b)) for a, b in zip(live, snapshot)), "the snapshot was not refreshed after the last train call")
    versions = [it["version"] for it in seen]
    check(all(it["model"] is runner.behavior_model for it in seen), "a rollout ran the trained model, not the snapshot")
    check(versions == [sgd_steps * k for k in range(iters)], f"rollout versions {versions}")
    check(all(int(it["stamp_min"]) == int(it["stamp_max"]) == it["version"] == it["train_step"] for it in seen),
          "trajectory stamps differ from the version before the train call")
    check(lags == [float(sgd_steps)] * iters, f"policy lag seen by the learner {lags}, expected {sgd_steps} each iteration")
    steady = per_iter[1:]
    rate = envs * 32 * len(steady) / sum(steady)
    turns = {"sync": [], "appo": []}
    for _ in range(3):
        for name, which in (("sync", sync_runner), ("appo", runner), ("appo", runner), ("sync", sync_runner)):
            turns[name].append(timed_iteration(torch, which))
    split = {"reps": {k: len(v) for k, v in turns.items()}, "stat": "median of iterations taken in turns, host clock, synced",
             "sync_gae": median_split(turns["sync"]), "async_vtrace": median_split(turns["appo"]),
             **advantage_loops_ms(torch, envs, 16384 // 32)}
    emit({"phase": "appo", "env": "grid_battle", "regime": "async_rl (default), with_vtrace", "envs": envs, "rollout": 32,
          "iterations": iters, "env_steps": runner.env_steps, "launches": counts, "iteration_s": per_iter,
          "rollout_versions": versions, "policy_lag_sgd_steps": lags, "env_steps_per_s_steady": rate,
          "env_steps_per_s_steady_sync_main": sync_rate, "regimes_in_turns": split,
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    return counts


DEFAULTS_ENVS, DEFAULTS_ITERS = 64, 2


def phase_defaults(torch, cuda_rnn, card, tmp):
    """`train_synthetic` on synthetic_vector_discrete with --use_rnn=True (it turns the core off) and no
    other flag: the cfg's defaults (GRU-512 float32, batch 1024, rollout 32, the async regime) at
    train_synthetic's 64 envs, 2 iterations; `gru_seq_grid` once a minibatch at DEFAULTS_GRU."""
    argv = ["--env=synthetic_vector_discrete", "--use_rnn=True", "--save_every_sec=100000", "--save_best_every_sec=100000",
            "--experiment_summaries_interval=100000", f"--train_for_env_steps={DEFAULTS_ITERS * DEFAULTS_ENVS * 32}",
            "--experiment=defaults"]

    def before_run(runner):
        cfg = runner.cfg
        check((cfg.rnn_type, cfg.rnn_size, cfg.compute_dtype, cfg.batch_size, cfg.rollout, cfg.num_envs, cfg.async_rl)
              == ("gru", 512, "float32", 1024, 32, DEFAULTS_ENVS, True), "not the cfg's defaults")

    with launch_shapes(cuda_rnn) as shapes:
        runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, before_run)
    per_iter = [b - a for a, b in zip(times, times[1:])]
    minibatches = DEFAULTS_ENVS * 32 // 1024
    check(len(per_iter) == DEFAULTS_ITERS, f"expected {DEFAULTS_ITERS} iterations, ran {len(per_iter)}")
    check(counts["gru_seq_grid"] == DEFAULTS_ITERS * minibatches and forward_launches(counts) == counts["gru_seq_grid"],
          f"launches {counts}: expected {minibatches} gru_seq_grid an iteration and no other forward kernel")
    check_backward_launches(counts, "defaults")
    check(set(shapes) == {("gru", *DEFAULTS_GRU[:3])}, f"launch shapes {set(shapes)}")
    emit({"phase": "defaults", "env": "synthetic_vector_discrete", "envs": DEFAULTS_ENVS, "rollout": 32, "batch": 1024,
          "model": "MLP 128-128, GRU-512 float32", "iterations": DEFAULTS_ITERS, "launches": counts, "iteration_s": per_iter,
          "env_steps_per_s_all": runner.env_steps / sum(per_iter), "loss": stats["loss"], "card": card})
    return counts


def phase_ant(torch, cuda_rnn, card, tmp):
    from sample_factory_tpu_torch.models.action_parameterization import ActionParameterizationDefault

    iters, envs, rollout = 2, 4096, 16
    argv = QUIET + ["--env=ant", "--use_rnn=False", "--encoder_mlp_layers", "256", "128", "64", f"--rollout={rollout}",
                    "--recurrence=1", "--batch_size=32768", "--num_epochs=4", f"--num_envs={envs}", "--async_rl=False",
                    "--normalize_input=True", "--normalize_returns=True",
                    f"--train_for_env_steps={iters * envs * rollout}", "--experiment=ant"]
    seen = []
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, lambda runner: record_rollouts(runner, seen))
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == iters, f"expected {iters} iterations, ran {len(per_iter)}")
    check(all(v == 0 for v in counts.values()), f"an RNN kernel launched on the feed-forward path: {counts}")
    check(all(it["actions_shape"] == (rollout, envs, 8) and it["actions_dtype"] == torch.float32 for it in seen),
          f"action tensors {[(it['actions_shape'], it['actions_dtype']) for it in seen]}")
    obs = runner.sampler_state.obs["obs"]
    check(tuple(obs.shape) == (envs, 59) and bool(torch.isfinite(obs).all()), "ant observations are not finite [4096, 59]")
    state = runner.sampler_state.env_states
    check(all(bool(torch.isfinite(v).all()) for k, v in state.items() if k != "steps"), "ant physics state is not finite")
    head = runner.model.action_parameterization
    check(runner.cfg.adaptive_stddev and isinstance(head, ActionParameterizationDefault)
          and head.distribution_linear.out_features == 16, "not the adaptive-stddev head (8 means + 8 log-stddevs)")
    check(runner.train_state.returns_rms is not None and runner.train_state.obs_rms is not None, "normalizers missing")
    split = median_split([timed_iteration(torch, runner) for _ in range(3)])
    emit({"phase": "ant", "env": "ant", "envs": envs, "rollout": rollout, "iterations": iters, "env_steps": runner.env_steps,
          "launches": counts, "iteration_s": per_iter, "env_steps_per_s_last": envs * rollout / per_iter[-1],
          "split_median_of_3_more_iterations": split, "epochs_executed": stats["epochs_executed"],
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    return counts


def phase_towers(torch, cuda_rnn, card, tmp):
    import copy

    import numpy as np

    envs, minibatches, layers, H = 128, 1, 2, 256
    argv = GRID_BATTLE + ["--encoder_conv_architecture=resnet_impala", "--actor_critic_share_weights=False", "--rnn_type=lstm",
                          f"--rnn_num_layers={layers}", "--optimizer=lamb", "--lamb_lookahead=True", "--compute_dtype=float32",
                          "--batch_size=4096", f"--num_envs={envs}", f"--train_for_env_steps={envs * 32}",
                          "--experiment=grid_battle_towers"]
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp)
    per_minibatch = 2 * layers  # 2 towers x 2 layers, one launch each per minibatch
    check(counts["lstm_seq"] == per_minibatch * minibatches, f"LSTM kernel launches {counts}, expected {per_minibatch * minibatches}")
    check(not any(others(counts, "lstm_seq").values()), f"other kernels launched on the LSTM path: {counts}")
    check_backward_launches(counts, "towers")
    group = runner.train_state.optimizer.param_groups[0]
    check(group["lookahead"] and group["step"] == minibatches, f"LAMB with lookahead took {group['step']} steps")

    # the trained model on the card against a deep copy on the CPU (plain versions)
    model = runner.train_state.model
    cpu_model = copy.deepcopy(model).cpu()
    rng = np.random.default_rng(3)
    S, R = 4, 32
    obs = torch.tensor(rng.random((S, R, 24, 24, 3)).astype(np.float32))
    rnn = torch.tensor((rng.normal(size=(S, 2 * layers * 2 * H)) * 0.5).astype(np.float32))
    resets = torch.tensor((rng.random((R, S)) < 0.1).astype(np.float32))

    def forward(m, device):
        head = m.forward_head({"obs": obs.to(device)})
        outs, final = m.forward_core_seq(head.transpose(0, 1), rnn.to(device), resets.to(device))
        logits, values = m.forward_tail(outs.transpose(0, 1).reshape(S * R, -1))
        return logits, values, final

    with torch.no_grad():
        before = forward_launches(cuda_rnn.launch_counts())
        on_card = forward(model, "cuda")
        torch.cuda.synchronize()
        check(forward_launches(cuda_rnn.launch_counts()) == before + per_minibatch, "model check did not run the LSTM kernels")
        on_cpu = forward(cpu_model, "cpu")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(on_card, on_cpu))
    tol = 1e-3  # float32 with TF32 off; convolution and matmul sums run in other orders on the two devices
    emit({"phase": "towers", "envs": envs, "env_steps": runner.env_steps, "launches": counts,
          "launches_per_minibatch": per_minibatch, "iteration_s": [b - a for a, b in zip(times, times[1:])],
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "model_card_vs_cpu_max_abs_err": err, "tol": tol, "card": card})
    check(all(bool(torch.isfinite(t).all()) for t in on_card), "non-finite model outputs")
    check(err <= tol, f"model on the card vs the CPU: {err} > {tol}")
    return counts


def worst_policy_objective(values):
    """An observer that publishes the stat `--pbt_target_objective` names, as a user's observer
    would (`policy_avg_stats`): which policy PBT finds the worst then does not hang on the luck
    of a few random-policy episodes."""
    from sample_factory_tpu_torch.runner.runner import AlgoObserver

    class Objective(AlgoObserver):
        def on_init(self, runner):
            runner.policy_avg_stats[runner.cfg.pbt_target_objective] = [[v] for v in values]

    return Objective()


def policy_tensors(torch, ts):
    """Every tensor of one policy's train state: parameters, optimizer state, normalizers."""
    out = dict(ts.model.state_dict())
    for i, state in ts.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": v for k, v in state.items() if torch.is_tensor(v)})
    for key, rms in (ts.obs_rms or {}).items():
        out.update({f"obs_rms.{key}.{k}": v for k, v in rms.state_dict().items()})
    if ts.returns_rms is not None:
        out.update({f"returns_rms.{k}": v for k, v in ts.returns_rms.state_dict().items()})
    return out


def phase_population(torch, cuda_rnn, card, tmp):
    """Two policies, each on its own 512 envs, with PBT. A policy's 16384 env steps an iteration
    make PBT due after iterations 2 and 4 (start and period 32768 env steps a policy)."""
    iters, envs, P = 4, 1024, 2
    argv = COMMON + MAIN_MODEL + [f"--num_envs={envs}", f"--num_policies={P}", "--with_pbt=True", "--pbt_start_mutation=32768",
                                  "--pbt_period_env_steps=32768", "--pbt_mutation_rate=1.0", "--pbt_replace_fraction=0.5",
                                  "--pbt_replace_reward_gap=0.0", "--pbt_replace_reward_gap_absolute=0.0",
                                  f"--train_for_env_steps={iters * envs * 32}", "--experiment=grid_battle_population"]
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, observers=[worst_policy_objective([1.0, 0.0])])
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(type(runner).__name__ == "MultiPolicyRunner" and not runner.mixed and runner.envs_per_policy == envs // P, "not the unmixed population runner")
    check(len(per_iter) == iters, f"expected {iters} iterations, ran {len(per_iter)}")
    check(counts["gru_seq"] == P * iters, f"GRU kernel launches {counts['gru_seq']}, expected {P * iters} (1 a policy and iteration)")
    check(not any(others(counts, "gru_seq").values()), f"other kernels launched: {counts}")
    check_backward_launches(counts, "population")
    plan = cuda_rnn.launch_plan("gru", *MAIN_GRU, SPEC)
    check(plan.design == "cluster", "the population's (32, 512, 256) bf16 launches do not take the cluster design")

    # PBT: policy 1 was updated; its files, its shaping where the rollout reads it, its hparams where the learner does
    exp = os.path.join(tmp, "grid_battle_population")
    check(runner.pbt.last_update == [iters * envs * 32 // P] * P, f"PBT rounds at {runner.pbt.last_update}")
    with open(os.path.join(exp, "policy_01_reward_shaping.json")) as f:
        shaping = json.load(f)
    with open(os.path.join(exp, "policy_01_cfg.json")) as f:
        hparams = json.load(f)
    check(runner.sampler_state[1].shaping == shaping and shaping != runner.env.reward_shaping, f"policy 1's shaping {runner.sampler_state[1].shaping} vs file {shaping}")
    check(runner.sampler_state[0].shaping == runner.env.reward_shaping, "policy 0's shaping moved")
    check(runner.train_state[1].hparams == hparams and hparams != runner.train_state[0].hparams, "policy 1's hparams are not the file's")
    for p in range(P):
        ckpts = [f for f in os.listdir(os.path.join(exp, f"checkpoint_p{p}")) if f.startswith("checkpoint_")]
        check(len(ckpts) >= 1, f"no checkpoint of policy {p}")
    rewards = [es.avg_reward for es in runner.episode_stats_per_policy]
    episodes = [es.total_episodes for es in runner.episode_stats_per_policy]
    check(all(r is None or math.isfinite(r) for r in rewards), f"per-policy rewards {rewards}")

    # one more iteration with a sync after each part, per policy
    split = []
    for p, ts in enumerate(runner.train_state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.sampler_state[p], traj, _ = runner._rollout_fn(ts.model, ts.obs_rms, runner.sampler_state[p], ts.train_step, p)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runner._train_fn(ts, traj, runner.train_generators[p], pid=p)
        torch.cuda.synchronize()
        split.append({"policy": p, "rollout_ms": (t1 - t0) * 1e3, "train_ms": (time.perf_counter() - t1) * 1e3})

    one_more_s = sum(part["rollout_ms"] + part["train_ms"] for part in split) / 1e3
    device = device_share(torch, runner._train_iteration, one_more_s)

    # the exploit step by itself: policy 0 into policy 1, on the card
    ts0, ts1 = runner.train_state
    with torch.no_grad():
        next(ts1.model.parameters()).add_(1.0)  # they differ before the copy whatever PBT did last
    step_before = ts1.train_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.pbt._replace_weights(runner.train_state, dst=1, src=0)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    src, dst = policy_tensors(torch, ts0), policy_tensors(torch, ts1)
    check(set(src) == set(dst) and any(k.startswith("optimizer.") for k in src) and any(k.startswith("obs_rms.") for k in src),
          f"tensors of the two policies: {sorted(set(src) ^ set(dst))}")
    on_card = [k for k in src if src[k].is_cuda]
    check(len(on_card) >= len(list(ts0.model.parameters())) * 3, "parameters and moments are not on the card")
    check(all(bool(torch.equal(src[k], dst[k])) for k in src), "the exploit copy left a tensor of policy 1 different from policy 0's")
    check(all(src[k].data_ptr() != dst[k].data_ptr() for k in src), "the exploit copy shares storage between the policies")
    check(ts1.train_step == step_before + runner.cfg.max_policy_lag + 1, f"train_step {step_before} -> {ts1.train_step}")
    steady = per_iter[1:]
    emit({"phase": "population", "env": "grid_battle", "policies": P, "envs_per_policy": envs // P, "rollout": 32, "iterations": iters,
          "env_steps": runner.env_steps, "launches": counts, "launches_per_iteration": counts["gru_seq"] / iters, "iteration_s": per_iter,
          "env_steps_per_s_steady": envs * 32 * len(steady) / sum(steady), "split_one_more_iteration": split,
          "device_in_one_profiled_iteration": device, "exploit_copy_ms": copy_ms, "exploit_copy_tensors": len(src), "pbt_last_update": runner.pbt.last_update,
          "policy_1_hparams": hparams, "policy_1_shaping": shaping, "avg_reward": rewards, "episodes": episodes,
          "loss": [s["loss"] for s in stats], "grad_norm": [s["grad_norm"] for s in stats], "card": card})
    return counts


SELFPLAY = ["--env=grid_duel", "--encoder_conv_architecture=resnet_impala", "--use_rnn=True", "--num_policies=2",
            "--pbt_mix_policies_in_one_env=True", "--async_rl=False", "--rollout=32", "--recurrence=32", "--num_epochs=1"] + QUIET


def phase_selfplay(torch, cuda_rnn, card, tmp):
    import copy

    import numpy as np

    from sample_factory_tpu_torch.algo.learning import init_train_state

    iters, envs, P, A = 3, 512, 2, 2
    slots = envs * A
    argv = SELFPLAY + ["--compute_dtype=bfloat16", "--batch_size=16384", f"--num_envs={envs}",
                       f"--train_for_env_steps={iters * slots * 32}", "--experiment=grid_duel_selfplay"]
    seen = []

    def before_run(runner):
        rollout_fn = runner._rollout_fn

        def rollout(models, obs_rms, ss, slot_policies, versions):
            out = rollout_fn(models, obs_rms, ss, slot_policies, versions)
            want = torch.arange(slots, device=out[1]["policy_id"].device, dtype=torch.int32) % P
            seen.append({"policy_id_is_slot_mod_P": (out[1]["policy_id"] == want[None, :]).all(), "versions": list(versions),
                         "shape": tuple(out[1]["policy_id"].shape)})
            return out

        runner._rollout_fn = rollout

    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, before_run)
    per_iter = [b - a for a, b in zip(times, times[1:])]
    cfg = runner.cfg
    check(runner.mixed and runner.num_slots == slots and cfg.rnn_size == 512 and cfg.compute_dtype == "bfloat16", "not the mixed GRU-512 bf16 run")
    check(len(per_iter) == iters == len(seen), f"expected {iters} iterations, ran {len(per_iter)}")
    # each policy trains on all 1024 slots x 32 steps: 2 minibatches of 512 segments, so 4 launches an iteration
    check(counts["gru_seq"] == 2 * P * iters, f"GRU kernel launches {counts['gru_seq']}, expected {2 * P * iters}")
    check(not any(others(counts, "gru_seq").values()), f"other kernels launched: {counts}")
    check_backward_launches(counts, "selfplay")
    check(all(bool(it["policy_id_is_slot_mod_P"]) and it["shape"] == (32, slots) for it in seen), "policy_id is not slot % 2 everywhere")
    check([it["versions"] for it in seen] == [[2 * k] * P for k in range(iters)], f"rollout versions {[it['versions'] for it in seen]}")
    check(all(s["valids_fraction"] == 0.5 for s in stats), f"valids fractions {[s['valids_fraction'] for s in stats]}")
    params = [list(ts.model.parameters()) for ts in runner.train_state]
    check(all(bool(torch.isfinite(p).all()) for ps in params for p in ps), "non-finite parameters")
    check(any(not bool(torch.equal(a, b)) for a, b in zip(*params)), "the two policies' parameters are equal")
    runner._drain_ep_stats()
    episodes = [es.total_episodes for es in runner.episode_stats_per_policy]
    check(episodes[0] == episodes[1], f"per-policy episode counts {episodes}")

    # one more iteration, a sync after each part: the shared rollout, then each policy's train call
    states = runner.train_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.sampler_state, traj, _ = runner._rollout_fn([ts.model for ts in states], [ts.obs_rms for ts in states], runner.sampler_state,
                                                       runner._slot_policies, [ts.train_step for ts in states])
    torch.cuda.synchronize()
    split = {"rollout_ms": (time.perf_counter() - t0) * 1e3, "train_ms": []}
    for p, ts in enumerate(states):
        t1 = time.perf_counter()
        runner._train_fn(ts, traj, runner.train_generators[p], pid=p)
        torch.cuda.synchronize()
        split["train_ms"].append((time.perf_counter() - t1) * 1e3)
    device = device_share(torch, runner._train_iteration, (split["rollout_ms"] + sum(split["train_ms"])) / 1e3)
    steady = per_iter[1:]
    emit({"phase": "selfplay", "env": "grid_duel", "policies": P, "envs": envs, "slots": slots, "rollout": 32, "rnn_size": cfg.rnn_size,
          "iterations": iters, "env_steps": runner.env_steps, "launches": counts, "launches_per_iteration": counts["gru_seq"] / iters,
          "iteration_s": per_iter, "env_steps_per_s_steady": slots * 32 * len(steady) / sum(steady), "split_one_more_iteration": split,
          "device_in_one_profiled_iteration": device, "valids_fraction": [s["valids_fraction"] for s in stats], "loss": [s["loss"] for s in stats],
          "grad_norm": [s["grad_norm"] for s in stats], "episodes": episodes, "card": card})
    del runner, states, traj, params

    # float32 at a cut depth (16 envs, 32 slots; the widths stay): one train call of policy 0 on the
    # card against the same call on a CPU copy, from the same trajectory
    small, small_slots = 16, 32
    argv = SELFPLAY + ["--compute_dtype=float32", "--batch_size=512", f"--num_envs={small}",
                       f"--train_for_env_steps={small_slots * 32}", "--experiment=grid_duel_selfplay_f32"]
    runner, f32_counts, _, _ = train(torch, cuda_rnn, argv, tmp)
    check(forward_launches(f32_counts) == 2 * P, f"float32 self-play launches {f32_counts}")
    check_backward_launches(f32_counts, "selfplay float32")
    ts = runner.train_state[0]
    cpu_model = copy.deepcopy(ts.model).cpu()
    cpu_ts = init_train_state(runner.cfg, runner.env_info, cpu_model, "cpu")
    # onto the CPU: parameters, Adam's moments, normalizers (a deep copy first: an optimizer keeps
    # the tensors it is given where device and type already match)
    cpu_ts.load_state_dict(copy.deepcopy(ts.state_dict()))
    states = runner.train_state
    runner.sampler_state, traj, _ = runner._rollout_fn([t.model for t in states], [t.obs_rms for t in states], runner.sampler_state,
                                                       runner._slot_policies, [t.train_step for t in states])
    cpu_traj = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu()) for k, v in traj.items()}
    before = cuda_rnn.launch_counts()
    runner._train_fn(ts, traj, runner.train_generators[0], pid=0)
    torch.cuda.synchronize()
    after = cuda_rnn.launch_counts()
    check(forward_launches(after) == forward_launches(before) + 2 and backward_launches(after) == backward_launches(before) + 2,
          f"the float32 train call did not launch the kernel and its backward twice: {before} -> {after}")
    runner._train_fn(cpu_ts, cpu_traj, torch.Generator().manual_seed(0), pid=0)
    check(cpu_ts.train_step == ts.train_step, "the two train calls took different numbers of steps")
    param_err = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in zip(ts.model.parameters(), cpu_model.parameters()))

    rng = np.random.default_rng(3)
    S, R = 4, 32
    obs = torch.tensor(rng.random((S, R, 16, 16, 3)).astype(np.float32))
    rnn = torch.tensor((rng.normal(size=(S, 512)) * 0.5).astype(np.float32))
    resets = torch.tensor((rng.random((R, S)) < 0.1).astype(np.float32))
    resets[:, 1::2] = 1.0  # every second segment reset at every step, as another policy's slots are

    def forward(m, device):
        head = m.forward_head({"obs": obs.to(device)})
        outs, final = m.forward_core_seq(head.transpose(0, 1), rnn.to(device), resets.to(device))
        logits, values = m.forward_tail(outs.transpose(0, 1).reshape(S * R, -1))
        return logits, values, final

    with torch.no_grad():
        on_card = forward(ts.model, "cuda")
        torch.cuda.synchronize()
        on_cpu = forward(cpu_model, "cpu")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(on_card, on_cpu))
    # float32 with TF32 off; sums run in other orders on the two devices, and Adam's first steps move a
    # parameter by about lr whatever its gradient's size, so a gradient near 0 can move it by 2 lr apart
    tol = 1e-3
    emit({"phase": "selfplay", "check": "one float32 train call of policy 0, card vs CPU copy", "envs": small, "slots": small_slots,
          "rnn_size": runner.cfg.rnn_size, "launches": f32_counts, "plan": dataclasses.asdict(cuda_rnn.launch_plan("gru", 32, 16, 512, "float32", SPEC)),
          "params_max_abs_err": param_err, "model_outputs_max_abs_err": err, "tol": tol, "card": card})
    check(all(bool(torch.isfinite(t).all()) for t in on_card), "non-finite model outputs")
    check(param_err <= tol and err <= tol, f"card vs CPU after one train call: parameters {param_err}, outputs {err} > {tol}")
    return counts


def phase_enjoy(torch, card, tmp):
    from sample_factory_tpu_torch.enjoy import enjoy
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args

    cfg = parse_custom_args(["--env=grid_battle", "--experiment=grid_battle_appo", f"--train_dir={tmp}", "--no_render"], evaluation=True)
    episodes = []
    start = time.perf_counter()
    status, avg_reward = enjoy(cfg, num_episodes=8, num_envs=16, collect_episodes=episodes)
    check(status == 0, f"enjoy returned status {status}")
    check(len(episodes) >= 8 and math.isfinite(avg_reward), f"enjoy: {len(episodes)} episodes, average reward {avg_reward}")
    emit({"phase": "enjoy", "checkpoint_of": "appo", "envs": 16, "episodes": len(episodes), "avg_reward": avg_reward,
          "avg_len": sum(n for _, n in episodes) / len(episodes), "seconds": time.perf_counter() - start, "card": card})

    # a policy of a population, by its index
    cfg = parse_custom_args(["--env=grid_battle", "--experiment=grid_battle_population", f"--train_dir={tmp}", "--no_render",
                             "--policy_index=1"], evaluation=True)
    episodes = []
    start = time.perf_counter()
    status, avg_reward = enjoy(cfg, num_episodes=8, num_envs=16, collect_episodes=episodes)
    check(status == 0 and len(episodes) >= 8 and math.isfinite(avg_reward), f"enjoy --policy_index=1: status {status}, {len(episodes)} episodes")
    emit({"phase": "enjoy", "checkpoint_of": "population", "policy_index": 1, "envs": 16, "episodes": len(episodes),
          "avg_reward": avg_reward, "seconds": time.perf_counter() - start, "card": card})


EXPORT_BATCH = 1024
EXPORT_STEPS = 32
EXPORT_TOL = 0.03  # the bf16 tolerance of tests/test_torch_models.py


def phase_export(torch, card, tmp):
    """`export_model` on `main`'s checkpoint (grid_battle, convnet_impala + Dense 256, GRU-256,
    bf16) at batch 1024 on the card; the reloaded program steps 1024 envs for 32 steps with
    its own rnn state fed back, beside the eager deterministic policy on the same inputs."""
    from sample_factory_tpu_torch.algo.sampling import init_sampler_state, normalize_obs
    from sample_factory_tpu_torch.envs.device_env import autoreset_step
    from sample_factory_tpu_torch.envs.env_utils import create_env
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.export_model import build_inference_fn, export_model, load_exported_model, load_policy
    from sample_factory_tpu_torch.models.actor_critic import initial_actor_critic_state

    def export_cfg(deterministic):
        return parse_custom_args(["--env=grid_battle", "--experiment=grid_battle_gru", f"--train_dir={tmp}",
                                  f"--eval_deterministic={deterministic}"], evaluation=True)

    torch.cuda.synchronize()
    start = phase_start = time.perf_counter()
    path = export_model(export_cfg(True), batch_size=EXPORT_BATCH, output_path=os.path.join(tmp, "policy_greedy.pt2"))
    export_s = time.perf_counter() - start
    program = load_exported_model(path)
    cfg, env_info, ts = load_policy(export_cfg(True))
    eager = build_inference_fn(cfg, env_info, ts.model, ts, deterministic=True)
    check(cfg.compute_dtype == "bfloat16" and cfg.rnn_size == 256, f"export: not main's model ({cfg.compute_dtype}, {cfg.rnn_size})")

    env = create_env(cfg.env, cfg=cfg)
    generator = torch.Generator("cuda").manual_seed(7)
    ss = init_sampler_state(cfg, env, EXPORT_BATCH, torch.device("cuda"), generator)
    rnn = initial_actor_critic_state(cfg, EXPORT_BATCH, "cuda")
    rnn_err, mismatched, ties, decided = 0.0, 0, 0, 0
    with torch.no_grad():
        for _ in range(EXPORT_STEPS):
            obs = {k: v.float() for k, v in ss.obs.items()}
            actions, new_rnn = program(obs, rnn)
            check(actions.device == torch.device("cuda", 0) and new_rnn.device == torch.device("cuda", 0),
                  f"export: outputs on {actions.device} and {new_rnn.device}")
            eager_actions, eager_rnn = eager(obs, rnn)
            rnn_err = max(rnn_err, float((new_rnn - eager_rnn).abs().max()))
            logits = eager.model(normalize_obs(cfg, eager.obs_rms, obs), rnn)[0].float()
            top2 = logits.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > EXPORT_TOL
            mismatched += int(((actions != eager_actions)[:, 0] & clear).sum())
            ties += int((~clear).sum())
            decided += int(clear.sum())
            ss.obs, ss.env_states, _, dones, _ = autoreset_step(env, ss.env_states, actions, generator=generator)
            rnn = torch.where(dones[:, None].bool(), torch.zeros_like(new_rnn), new_rnn)
        torch.cuda.synchronize()
        check(rnn_err <= EXPORT_TOL, f"export: rnn state {rnn_err} from the eager policy's (tol {EXPORT_TOL})")
        check(mismatched == 0, f"export: {mismatched} of {decided} clear actions differ from the eager policy's")

        obs = {k: v.float() for k, v in ss.obs.items()}
        ms = time_ms(torch, lambda: program(obs, rnn))
        eager_ms = time_ms(torch, lambda: eager(obs, rnn))

        # a sampling policy takes its draws as its third input
        sampling_path = export_model(export_cfg(False), batch_size=EXPORT_BATCH, output_path=os.path.join(tmp, "policy_sampling.pt2"))
        sampler = load_exported_model(sampling_path)
        noise = torch.rand((EXPORT_BATCH, eager.noise_width), generator=generator, device="cuda")
        sampled, sampled_rnn = sampler(obs, rnn, noise)
        torch.cuda.synchronize()
        n_actions = env_info.action_space.n
        check(sampled.shape == (EXPORT_BATCH, 1) and sampled.dtype == torch.int32 and sampled.device == torch.device("cuda", 0),
              f"export: sampled actions {tuple(sampled.shape)} {sampled.dtype} on {sampled.device}")
        check(0 <= int(sampled.min()) and int(sampled.max()) < n_actions, "export: sampled actions out of range")
        check(bool(torch.isfinite(sampled_rnn).all()), "export: non-finite rnn state from the sampling program")
        sampled_share = float((sampled != program(obs, rnn)[0]).float().mean())
    emit({"phase": "export", "checkpoint_of": "main", "batch": EXPORT_BATCH, "steps": EXPORT_STEPS, "export_s": export_s,
          "pt2_bytes": os.path.getsize(path), "rnn_max_abs_err": rnn_err, "tol": EXPORT_TOL, "tie_share": ties / (ties + decided),
          "clear_actions": decided, "mismatched_clear_actions": mismatched, "ms_per_exported_step": ms, "ms_per_eager_step": eager_ms,
          "sampled_actions_not_greedy_share": sampled_share, "phase_s": time.perf_counter() - phase_start, "reps": REPS,
          "stat": "median of CUDA-event times after warm-up, a spin of the card before each", "card": card})


# ------------------------------------------------------------------ host envs

QUIET_HOST = [a for a in QUIET if a != "--num_workers=1"]
HOST_PIXEL = ["--env=bench_host_pixel", "--num_workers=2", "--num_envs_per_worker=1024", "--worker_num_splits=2", "--rollout=32",
              "--batch_size=8192", "--num_epochs=1", "--encoder_conv_architecture=convnet_simple", "--encoder_conv_mlp_layers", "128",
              "--normalize_input=True", "--decorrelate_envs_on_one_worker=False"] + QUIET_HOST
HOST_SLOTS, HOST_ENVS, HOST_OBS_BYTES = 64, 2048, 42 * 42 * 4  # (timestep, split) slots a rollout; envs; bytes a frame stack


def shm_segments():
    """This process's host-sampler segments still in /dev/shm (ShmSlabs names them sftpu_<pid>_...)."""
    return [n for n in os.listdir("/dev/shm") if n.startswith(f"sftpu_{os.getpid()}_")]


def record_host_rollouts(runner, seen):
    """Wrap the host sampler's collect_rollout: what each rollout was given and what came out."""
    collect = runner.sampler.collect_rollout

    def recording_collect(model, obs_rms, version, *args, **kwargs):
        q = runner._quantizer
        dispatched_before = (q.total_quanta_enqueued - q.pending) if q is not None else 0
        traj, stats = collect(model, obs_rms, version, *args, **kwargs)
        tensors = {**{f"obs/{k}": v for k, v in traj["obs"].items()}, **{k: v for k, v in traj.items() if k != "obs"}}
        seen.append({"model": model, "version": version, "behavior_version_host": runner._behavior_version_host,
                     "devices": {str(v.device) for v in tensors.values()}, "obs_dtype": traj["obs"]["obs"].dtype,
                     "obs_shape": tuple(traj["obs"]["obs"].shape), "stamp_min": traj["policy_version"].min(), "stamp_max": traj["policy_version"].max(),
                     "quanta_in_rollout": ((q.total_quanta_enqueued - q.pending) - dispatched_before) if q is not None else 0,
                     "episodes": stats["count"]})
        return traj, stats

    runner.sampler.collect_rollout = recording_collect


def slot_ms(sampler):
    return {k: 1e3 * v / max(1, sampler.slots_timed) for k, v in sampler.slot_seconds.items()}


def reset_slot_timers(sampler):
    sampler.slot_seconds = dict.fromkeys(sampler.slot_seconds, 0.0)
    sampler.slots_timed = 0


def host_run(torch, cuda_rnn, tmp, argv, iters, experiment, captured=None):
    """One run of the host path through make_rl_runner -> init -> run with no --device flag; with `captured`, the
    learner's last train step is kept there (`capture_train_steps`)."""
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.runner.runner import AlgoObserver

    seen, initial, workers = [], [], []

    class SteadyTimers(AlgoObserver):
        """The per-slot timers count from the second iteration on."""

        def __init__(self):
            self.iterations = 0

        def on_training_iteration(self, runner, stats):
            self.iterations += 1
            if self.iterations == 1:
                reset_slot_timers(runner.sampler)

    def before_run(runner):
        check(type(runner).__name__ == "HostEnvRunner" and runner.device.type == "cuda", "not the host runner on the card")
        check(runner.sampler.transport == "shm_queue", f"transport {runner.sampler.transport}: the shared-memory queue did not build")
        check(runner.cfg.async_rl and runner._quantizer is not None, "not the default regime with the quantized learner")
        check(runner.behavior_model is not None and runner.behavior_model is not runner.train_state.model, "no behaviour snapshot")
        check(len(runner.sampler.workers) == 2 and all(p.is_alive() for p in runner.sampler.workers), "worker processes are not running")
        check(len(shm_segments()) >= 6, f"shared-memory slabs: {shm_segments()}")
        initial.extend(p.detach().clone() for p in runner.train_state.model.parameters())
        workers.extend(runner.sampler.workers)
        record_host_rollouts(runner, seen)
        if captured is not None:
            capture_train_steps(runner, captured)

    full = argv + [f"--train_for_env_steps={iters * HOST_ENVS * 32}", f"--experiment={experiment}"]
    runner, counts, stats, times = train(torch, cuda_rnn, full, tmp, before_run, observers=[SteadyTimers()],
                                         register_fn=register_bench_pixel, device_flag=())
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == iters == len(seen), f"expected {iters} iterations, ran {len(per_iter)}")
    q, sgd = runner._quantizer, runner._quantizer.sgd_steps_per_train
    check(sgd == 8 and q.num_minibatches == 8, f"{q.num_minibatches} minibatches a train step")
    for k, it in enumerate(seen):
        check(it["model"] is runner.behavior_model, "a rollout ran the trained model, not the snapshot")
        check(it["devices"] == {"cuda:0"}, f"trajectory tensors on {it['devices']}")
        check(it["obs_dtype"] == torch.uint8 and it["obs_shape"] == (33, HOST_ENVS, 42, 42, 4), f"observations {it['obs_dtype']} {it['obs_shape']}")
        check(int(it["stamp_min"]) == int(it["stamp_max"]) == it["version"] == it["behavior_version_host"] == sgd * max(0, k - 1),
              f"rollout {k}: stamps {int(it['stamp_min'])}..{int(it['stamp_max'])}, version {it['version']}")
    in_rollouts = q.total_quanta_enqueued - q.quanta_drained_at_flush
    check(q.total_quanta_enqueued == iters * (sgd + 2), f"{q.total_quanta_enqueued} quanta queued")
    check(all(it["quanta_in_rollout"] == sgd + 2 for it in seen[1:]) and seen[0]["quanta_in_rollout"] == 0 and in_rollouts == (iters - 1) * (sgd + 2),
          f"quanta inside rollouts {[it['quanta_in_rollout'] for it in seen]}, at flush {q.quanta_drained_at_flush}")
    check(runner.train_state.train_step == runner._version_host == iters * sgd, f"train_step {runner.train_state.train_step}, mirror {runner._version_host}")
    params = list(runner.train_state.model.parameters())
    check(all(bool(torch.isfinite(p).all()) for p in params), "non-finite parameters")
    check(all(not bool(torch.equal(a, b)) for a, b in zip(params, initial)), "a parameter did not change")
    check(all(not p.is_alive() for p in workers), "a worker process outlived the run")
    check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
    return runner, counts, stats, per_iter, seen


def phase_host(torch, cuda_rnn, card, tmp):
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.train import make_rl_runner

    iters = 6
    runner, counts, stats, per_iter, seen = host_run(torch, cuda_rnn, tmp, HOST_PIXEL + ["--use_rnn=False"], iters, "host_pixel")
    check(all(v == 0 for v in counts.values()), f"an RNN kernel launched on the feed-forward host path: {counts}")
    steady = per_iter[1:]
    q = runner._quantizer
    emit({"phase": "host", "env": "bench_host_pixel", "workers": 2, "envs": HOST_ENVS, "splits": 2, "rollout": 32, "batch": 8192,
          "transport": runner.sampler.transport, "iterations": iters, "env_steps": runner.env_steps, "launches": counts,
          "iteration_s": per_iter, "env_steps_per_s_steady": HOST_ENVS * 32 * len(steady) / sum(steady),
          "upload_bytes_per_iteration": 33 * HOST_ENVS * HOST_OBS_BYTES,
          "slot_ms_host_clock_iterations_2_on": slot_ms(runner.sampler), "slots_timed": runner.sampler.slots_timed,
          "quanta_per_train_step": q.sgd_steps_per_train + 2, "quanta_in_rollouts": q.total_quanta_enqueued - q.quanta_drained_at_flush,
          "quanta_at_flush": q.quanta_drained_at_flush, "rollout_versions": [it["version"] for it in seen],
          "policy_lag_sgd_steps": stats["version_diff_max"], "timing": runner.timing.flat_str(),
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    del runner

    # the two regimes in turns (sync, async, async, sync, three times), each on its own workers
    runners = {}
    try:
        for name in ("sync", "async"):
            argv = HOST_PIXEL + ["--use_rnn=False", f"--async_rl={name == 'async'}", "--train_for_env_steps=1000000000",
                                 f"--experiment=host_pixel_turns_{name}", f"--train_dir={tmp}", "--seed=0"]
            _, runners[name] = make_rl_runner(parse_custom_args(argv), register_fn=register_bench_pixel)
            runners[name].init()
            check(runners[name].sampler.transport == "shm_queue", "the turns do not run over the shared-memory queue")

        # the learner's share of an iteration on the host's clock: the fused train call (sync), or
        # the quanta that the pacer dispatches between the rollout's slots (async)
        learner_s = {"sync": 0.0, "async": 0.0}

        def clocked(name, fn):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                learner_s[name] += time.perf_counter() - t0
                return out
            return call

        runners["sync"]._train_fn = clocked("sync", runners["sync"]._train_fn)
        pacer = runners["async"]._pacer
        pacer.q.dispatch_one = clocked("async", pacer.q.dispatch_one)

        def timed(name):
            reset_slot_timers(runners[name].sampler)
            learner_s[name] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runners[name]._train_iteration()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            slots = slot_ms(runners[name].sampler)
            return {"iteration_ms": seconds * 1e3, "env_steps_per_s": HOST_ENVS * 32 / seconds,
                    "slots_ms": HOST_SLOTS * sum(slots.values()), "learner_host_ms": learner_s[name] * 1e3,
                    **{f"slot_{k}_ms": v for k, v in slots.items()}}

        for name in ("sync", "async", "async"):  # warm-up; the async runner needs a train step under way
            timed(name)
        turns = {"sync": [], "async": []}
        for _ in range(3):
            for name in ("sync", "async", "async", "sync"):
                turns[name].append(timed(name))
        split = {name: median_split(rows) for name, rows in turns.items()}
        device = device_share(torch, runners["async"]._train_iteration, split["async"]["iteration_ms"] / 1e3)
        qa = runners["async"]._quantizer
        check(qa.quanta_drained_at_flush == 0 and qa.total_quanta_enqueued > qa.pending, "the async runner in turns drained quanta at a flush")
        # one train step quantum by quantum, nothing else on the card: the host's time to dispatch
        # each, and the time until the device has finished it
        a = runners["async"]
        qa.flush()
        traj, _ = a.sampler.collect_rollout(a.behavior_model, a.behavior_obs_rms, a._behavior_version_host, a.policy_id)
        torch.cuda.synchronize()
        qa.enqueue(a.train_state, traj, a.train_generator)
        quanta = []
        while qa.pending:
            t0 = time.perf_counter()
            qa.dispatch_one()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            quanta.append({"host_ms": (t1 - t0) * 1e3, "until_device_done_ms": (time.perf_counter() - t0) * 1e3})
        a._version_host += qa.sgd_steps_per_train
        a._pending = False
        emit({"phase": "host", "check": "the regimes in turns", "reps": {k: len(v) for k, v in turns.items()},
              "stat": "median of iterations taken in turns, host clock, synced; slot times are host-clock ms per (timestep, split), "
                      "slots_ms their sum over the rollout's 64 slots, learner_host_ms the host's time in the train call (sync) or in the quanta (async)",
              "sync_fused_train_call": split["sync"], "async_quantized": split["async"],
              "async_over_sync_rate": split["async"]["env_steps_per_s"] / split["sync"]["env_steps_per_s"],
              "device_in_one_profiled_async_iteration": device,
              "one_train_step_quantum_by_quantum": {"order": "prepare, 8 sgd, lr", "host_ms": [q["host_ms"] for q in quanta],
                                                    "until_device_done_ms": [q["until_device_done_ms"] for q in quanta]}, "card": card})
    finally:
        for r in runners.values():
            r._finish_pending_work()
            r._release_resources()
            r._close_writers()
    check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
    return counts




def phase_host_rnn(torch, cuda_rnn, card, tmp):
    iters, minibatches = 3, 8
    plan = cuda_rnn.launch_plan("gru", *HOST_GRU, SPEC)
    check(plan.design == "cluster" and plan.cluster == 8, f"(32, 256, 256) bf16 takes {plan}")
    argv = HOST_PIXEL + ["--use_rnn=True", "--rnn_size=256", "--recurrence=32", "--compute_dtype=bfloat16"]
    captured = {}
    runner, counts, stats, per_iter, seen = host_run(torch, cuda_rnn, tmp, argv, iters, "host_pixel_gru", captured)
    # every queued train step ran (two inside rollouts, the last at the final flush): 8 launches each, in the learner only
    check(counts["gru_seq"] == minibatches * iters, f"GRU kernel launches {counts['gru_seq']}, expected {minibatches * iters}")
    check(not any(others(counts, "gru_seq").values()), f"other kernels launched on the host GRU path: {counts}")
    check_backward_launches(counts, "host_rnn")
    check(tuple(runner.sampler.rnn_states[0].shape) == (1024, 256), "the sampler's rnn state is not [1024, 256]")
    args = make_inputs(torch, "gru", *HOST_GRU, seed=4)
    with torch.no_grad():
        kernel_ms = time_ms(torch, lambda: cuda_rnn._launch_gru(*args))
        plain_ms = time_ms(torch, lambda: cuda_rnn.gru_seq_reference(*args))
        out, state = cuda_rnn._launch_gru(*args)
        ref_out, ref_state = cuda_rnn.gru_seq_reference(*args)
    err = max(float((out - ref_out).abs().max()), float((state - ref_state).abs().max()))
    check(err <= fwd_tol("bfloat16", 32), f"gru_seq at (32, 256, 256) bf16 disagrees with its plain version: {err}")
    bound_ms, bound_by, nbytes, flops = bound("gru", *HOST_GRU)
    steady = per_iter[1:]
    emit({"phase": "host_rnn", "env": "bench_host_pixel", "envs": HOST_ENVS, "rollout": 32, "rnn_size": 256, "iterations": iters,
          "env_steps": runner.env_steps, "launches": counts, "launches_per_train_step": minibatches, "iteration_s": per_iter,
          "env_steps_per_s_steady": HOST_ENVS * 32 * len(steady) / sum(steady), "slot_ms_host_clock_iterations_2_on": slot_ms(runner.sampler),
          "kernel_shape": list(HOST_GRU[:3]), "dtype": HOST_GRU[3], "design": dataclasses.asdict(plan), "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err, "reps": REPS,
          "timing": runner.timing.flat_str(), "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    learner_turns(torch, cuda_rnn, runner, captured, "host_rnn", card)
    return counts


def phase_host_selfplay(torch, cuda_rnn, card, tmp):
    """Smoke depth: the matching game (2 agents an env; pure numpy, its spaces in the port's own
    specs), 2 policies mixed inside the envs, 2 worker processes, async (the default), PBT due
    once, after iteration 3 (384 agent steps a policy), with policy 1 the worst."""
    from sample_factory_tpu_torch.examples import train_custom_multi_env as game

    game.register_custom_components()
    iters, slots, rollout, P = 5, 32, 16, 2
    per_iter = slots * rollout
    argv = QUIET_HOST + [f"--env={game.ENV_NAME}", "--num_policies=2", "--num_workers=2", "--num_envs_per_worker=8", "--worker_num_splits=2",
                         f"--rollout={rollout}", "--batch_size=256", "--encoder_mlp_layers", "64", "64", "--use_rnn=False",
                         "--custom_env_episode_len=4", "--pbt_mix_policies_in_one_env=True", "--with_pbt=True",
                         f"--pbt_start_mutation={3 * per_iter // 2}", f"--pbt_period_env_steps={3 * per_iter // 2}", "--pbt_mutation_rate=1.0",
                         "--pbt_replace_fraction=0.5", "--pbt_replace_reward_gap=0.0", "--pbt_replace_reward_gap_absolute=0.0",
                         f"--train_for_env_steps={iters * per_iter}", "--experiment=host_selfplay"]
    seen, pushed, workers = [], [], []

    def before_run(runner):
        check(type(runner).__name__ == "HostMultiPolicyRunner" and runner.device.type == "cuda", "not the host multi-policy runner on the card")
        check(runner.sampler.transport == "shm_queue" and runner.sampler.num_envs == slots and runner.env_info.num_agents == 2, "not 32 agent slots over the shared-memory queue")
        workers.extend(runner.sampler.workers)
        sampler = runner.sampler
        collect, finish, push = sampler.collect_rollout, sampler._finish_trajectory, sampler.set_reward_shaping
        active = []

        def recording_finish(*args):
            active.append(torch.as_tensor(sampler._host_buf["active"].copy()))
            return finish(*args)

        def recording_collect(models, obs_rms, versions, **kwargs):
            traj, stats = collect(models, obs_rms, versions, **kwargs)
            seen.append({"traj": traj, "slot_policies": kwargs["slot_policies"].copy(), "active": active.pop(), "iteration": len(seen),
                         "behaviour": models is runner.behavior_models})
            return traj, stats

        def recording_push(shaping, slot_mask=None):
            pushed.append({"shaping": dict(shaping), "mask": slot_mask.copy(), "after_iteration": len(seen)})
            return push(shaping, slot_mask)

        sampler._finish_trajectory, sampler.collect_rollout, sampler.set_reward_shaping = recording_finish, recording_collect, recording_push

    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, before_run, observers=[worst_policy_objective([1.0, 0.0])],
                                         register_fn=game.register_custom_components, device_flag=())
    check(all(v == 0 for v in counts.values()), f"an RNN kernel launched: {counts}")
    check(len(seen) == iters and all(it["behaviour"] for it in seen), f"{len(seen)} rollouts, or one ran the trained modules")
    for it in seen:
        pid = it["traj"]["policy_id"].cpu()
        flat = torch.as_tensor(it["slot_policies"].reshape(-1))[None].expand_as(pid)
        inactive = it["active"] == 0
        check(str(it["traj"]["policy_id"].device) == "cuda:0" and bool((pid[~inactive] == flat[~inactive]).all()), "policy_id differs from the slot's policy")
        check(bool((pid[inactive] == -1).all()) and bool(((pid == -1) == inactive).all()), "policy_id is -1 elsewhere than on inactive agents")
    check(bool(seen[0]["active"][:2].eq(0).all()) and int((seen[0]["active"] == 0).sum()) >= 2 * slots, "the agents did not sit out their first steps")
    check(runner.mapping_resamples >= 1, "the agent-policy mapping was never drawn anew")
    check(all(0.0 < s["valids_fraction"] < 1.0 for s in stats) and sum(s["valids_fraction"] for s in stats) <= 1.0 + 1e-6,
          f"valids fractions {[s['valids_fraction'] for s in stats]}")
    # PBT ran once: policy 1's mutated penalty went to the workers' envs, for the agents it drove then
    exp = os.path.join(tmp, "host_selfplay")
    with open(os.path.join(exp, "policy_01_reward_shaping.json")) as f:
        shaping = json.load(f)
    check(len(pushed) == 1 and pushed[0]["shaping"] == shaping and shaping["rew"] != -1.0, f"shaping pushed {pushed}, file {shaping}")
    mask = torch.as_tensor(pushed[0]["mask"].reshape(-1))
    check(0 < int(mask.sum()) < slots, "the shaping mask selects no slot, or all")
    later = [it for it in seen if it["iteration"] >= pushed[0]["after_iteration"]]
    check(len(later) >= 2, "no rollout after the PBT round")
    for it in later:
        rewards = it["traj"]["rewards"].cpu()
        paid_new = {round(float(v), 5) for v in rewards[:, mask].unique()}
        paid_old = {round(float(v), 5) for v in rewards[:, ~mask].unique()}
        check(paid_new <= {0.0, round(shaping["rew"], 5)} and round(shaping["rew"], 5) in paid_new, f"rewards of the reshaped agents {paid_new}, shaping {shaping}")
        check(paid_old <= {0.0, -1.0} and -1.0 in paid_old, f"rewards of the other agents {paid_old}")
    for p in range(P):
        ckpts = [f for f in os.listdir(os.path.join(exp, f"checkpoint_p{p}")) if f.startswith("checkpoint_")]
        check(len(ckpts) >= 1, f"no checkpoint of policy {p}")
    episodes = [es.total_episodes for es in runner.episode_stats_per_policy]
    check(sum(episodes) == iters * slots * (rollout // 4) and all(n > 0 for n in episodes), f"episodes credited {episodes}")
    check(all(not p.is_alive() for p in workers) and not shm_segments(), "a worker or a shared-memory segment outlived the run")
    per_iter_s = [b - a for a, b in zip(times, times[1:])]
    emit({"phase": "host_selfplay", "env": game.ENV_NAME, "policies": P, "agent_slots": slots, "rollout": rollout, "iterations": iters,
          "env_steps": runner.env_steps, "launches": counts, "iteration_s": per_iter_s, "mapping_resamples": runner.mapping_resamples,
          "valids_fraction": [s["valids_fraction"] for s in stats], "policy_1_shaping": shaping, "reshaped_slots": int(mask.sum()),
          "pbt_after_iteration": pushed[0]["after_iteration"], "episodes_credited": episodes,
          "inactive_share": float(sum(float((it["active"] == 0).float().mean()) for it in seen) / iters),
          "loss": [s["loss"] for s in stats], "card": card})
    return counts


def phase_host_enjoy(torch, card, tmp):
    from sample_factory_tpu_torch.enjoy import enjoy
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.eval import do_eval
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args

    base = ["--env=bench_host_pixel", "--experiment=host_pixel", f"--train_dir={tmp}"]
    episodes = []
    start = time.perf_counter()
    status, avg_reward = enjoy(parse_custom_args(base + ["--no_render", "--max_num_episodes=2"], evaluation=True), collect_episodes=episodes)
    check(status == 0 and len(episodes) == 2 and avg_reward == 512.0, f"enjoy on the host env: status {status}, episodes {episodes}")
    enjoy_s = time.perf_counter() - start
    # eval through the worker pool, at a cut depth: 2 workers x 64 envs (episodes last 512 steps)
    start = time.perf_counter()
    status = do_eval(parse_custom_args(base + ["--sample_env_episodes=64", "--num_envs_per_worker=64"], evaluation=True), register_fn=register_bench_pixel)
    with open(os.path.join(tmp, "host_pixel", "eval", "eval_p0.csv")) as f:
        rows = f.read().strip().splitlines()
    check(status == 0 and len(rows) == 65 and rows[1] == "0,512.0,512", f"eval on the host env: status {status}, {len(rows)} rows")
    check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
    emit({"phase": "host_enjoy", "checkpoint_of": "host", "enjoy_episodes": len(episodes), "avg_reward": avg_reward, "enjoy_seconds": enjoy_s,
          "eval_episodes": len(rows) - 1, "eval_seconds": time.perf_counter() - start, "card": card})


# ------------------------------------------------------------------ the examples users start from

CUSTOM_MODEL_STEPS, CUSTOM_MODEL_MIN_REWARD = 300_000, 100.0  # random play 32 an episode, perfect 128


@contextlib.contextmanager
def restored_encoder_factory():
    """A phase that registers an example's encoder factory leaves the previous one in place after it:
    the factory is global, and the later phases build their own encoders."""
    from sample_factory_tpu_torch.algo.context import global_model_factory

    factory = global_model_factory()
    previous = factory.encoder_factory
    try:
        yield
    finally:
        factory.encoder_factory = previous


def check_host_example(runner, workers, encoder_cls):
    model = runner.train_state.model
    check(type(runner).__name__ == "HostEnvRunner" and runner.device.type == "cuda", "not the host runner on the card")
    check(runner.sampler.transport == "shm_queue" and len(runner.sampler.workers) == workers, f"{len(runner.sampler.workers)} workers")
    check(runner.cfg.async_rl and runner._quantizer is not None, "not the default regime with the quantized learner")
    check(isinstance(model.encoder, encoder_cls) and isinstance(runner.behavior_model.encoder, encoder_cls),
          f"the encoder is {type(model.encoder).__name__}, not the example's")
    check({str(p.device) for p in model.parameters()} == {"cuda:0"}, "the model's parameters are not all on cuda:0")


def phase_custom_model(torch, cuda_rnn, card, tmp):
    """`examples/train_custom_env_custom_model.py` at its own defaults (2 workers x 32 envs, 2 splits,
    rollout 32, batch 1024, async with the quantized learner, normalize_input): the registered
    encoder on the card, trained to an average episode reward of at least 100; then `enjoy`."""
    with restored_encoder_factory():
        return custom_model_run(torch, cuda_rnn, card, tmp)


def custom_model_run(torch, cuda_rnn, card, tmp):
    from sample_factory_tpu_torch.enjoy import enjoy
    from sample_factory_tpu_torch.examples import train_custom_env_custom_model as pixel
    from sample_factory_tpu_torch.examples.custom_encoders import CustomPixelEncoder

    pixel.register_custom_components()
    seen = []

    def before_run(runner):
        check_host_example(runner, 2, CustomPixelEncoder)
        check(runner.cfg.normalize_input, "not the example's defaults")
        record_host_rollouts(runner, seen)

    argv = QUIET_HOST + ["--env=my_custom_pixel_env", f"--train_for_env_steps={CUSTOM_MODEL_STEPS}", "--experiment=custom_model"]
    start = time.perf_counter()
    runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, before_run, register_fn=pixel.register_custom_components,
                                         parse=pixel.parse_custom_args)
    seconds = time.perf_counter() - start
    check(all(v == 0 for v in counts.values()), f"an RNN kernel launched on a feed-forward path: {counts}")
    envs = runner.sampler.num_envs
    check(envs == 64 and runner.cfg.rollout == 32 and runner.cfg.batch_size == 1024, f"{envs} envs, not the example's 2 x 32")
    check(all(it["devices"] == {"cuda:0"} and it["obs_dtype"] == torch.uint8 and it["obs_shape"] == (33, envs, 42, 42, 4) for it in seen),
          "observations did not arrive on cuda:0 as uint8 [33, 64, 42, 42, 4]")
    reward = runner.episode_stats.avg_reward
    check(reward is not None and reward >= CUSTOM_MODEL_MIN_REWARD, f"average episode reward {reward} after {runner.env_steps} env steps")
    per_iter = [b - a for a, b in zip(times, times[1:])]

    episodes = []
    enjoy_start = time.perf_counter()
    status, enjoy_reward = enjoy(pixel.parse_custom_args(["--env=my_custom_pixel_env", "--experiment=custom_model", f"--train_dir={tmp}",
                                                          "--no_render", "--max_num_episodes=4"], evaluation=True), collect_episodes=episodes)
    check(status == 0 and len(episodes) == 4 and all(n == pixel.EPISODE_LEN for _, n in episodes), f"enjoy: status {status}, {episodes}")
    check(enjoy_reward >= CUSTOM_MODEL_MIN_REWARD, f"enjoy's average reward {enjoy_reward}")
    check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
    emit({"phase": "custom_model", "env": "my_custom_pixel_env", "encoder": "CustomPixelEncoder", "workers": 2, "envs": envs, "rollout": 32,
          "transport": runner.sampler.transport, "iterations": len(per_iter), "env_steps": runner.env_steps, "seconds": seconds,
          "env_steps_per_s": runner.env_steps / sum(per_iter), "avg_episode_reward": reward, "min_reward": CUSTOM_MODEL_MIN_REWARD,
          "enjoy_episodes": len(episodes), "enjoy_avg_reward": enjoy_reward, "enjoy_seconds": time.perf_counter() - enjoy_start,
          "launches": counts, "timing": runner.timing.flat_str(), "card": card})
    return counts


STANDIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "standins")  # envpool, vizdoom, deepmind_lab, nle, isaacgym
ATARI_FRAME_BYTES = 84 * 84 * 4


@contextlib.contextmanager
def standins_on_path(*modules):
    """tests/standins/ on sys.path and PYTHONPATH (spawned workers import the stand-ins from there);
    `modules` are dropped from sys.modules afterwards."""
    old_path = os.environ.get("PYTHONPATH")
    sys.path.insert(0, STANDIN_DIR)
    os.environ["PYTHONPATH"] = STANDIN_DIR + (os.pathsep + old_path if old_path else "")
    try:
        yield
    finally:
        sys.path.remove(STANDIN_DIR)
        for name in modules:
            sys.modules.pop(name, None)
        if old_path is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old_path


def phase_atari(torch, cuda_rnn, card, tmp):
    """`examples/envpool/train_envpool_atari.py` with --env=envpool_atari_breakout on the atari_params
    defaults and the module's usage line (32 envs a worker in 2 splits), over the stand-in envpool
    module of `tests/standins/`, which the workers import from the path: 4 iterations. The window
    from the start of an iteration to its first epoch's last SGD step is timed in every iteration,
    and in the 4th it runs under the profiler."""
    from sample_factory_tpu_torch.examples.envpool import train_envpool_atari as atari

    workers = min(8, os.cpu_count() or 1)
    envs, rollout, iters = workers * 32, 128, 4
    epoch_steps = envs * rollout // 256
    atari.register_envpool_atari_components()
    calls, rollouts, profile, slots = [], [], {}, {}
    window = {"t0": None, "steps": 0, "prof": None, "ms": []}

    def end_of_first_epoch(optimizer, args, kwargs):
        window["steps"] += 1
        if window["steps"] != epoch_steps:
            return
        torch.cuda.synchronize()
        window["ms"].append((time.perf_counter() - window["t0"]) * 1e3)
        prof, window["prof"] = window["prof"], None
        if prof is not None:
            stop = time.perf_counter()
            prof.stop()
            device_us, _, on_device, by_name = device_activities(prof)
            profile.update(wall_ms=window["ms"][-1], device_us=device_us, activities=len(on_device), stop_s=time.perf_counter() - stop,
                           top={k: v / 1e3 for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]})

    def before_run(runner):
        cfg = runner.cfg
        check(type(runner).__name__ == "HostEnvRunner" and runner.device.type == "cuda" and not cfg.async_rl, "not sync PPO on the card")
        check(runner.sampler.transport == "shm_queue" and len(runner.sampler.workers) == workers, f"{len(runner.sampler.workers)} workers")
        check(cfg.encoder_conv_architecture == "convnet_atari" and cfg.obs_scale == 255.0 and cfg.normalize_input and cfg.normalize_returns
              and cfg.lr_schedule == "linear_decay" and cfg.adam_eps == 1e-5 and cfg.batch_size == 256 and cfg.num_epochs == 4,
              "not the atari_params defaults")
        collect, train_fn, iteration = runner.sampler.collect_rollout, runner._train_fn, runner._train_iteration
        runner.train_state.optimizer.register_step_post_hook(end_of_first_epoch)

        def timed_collect(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            traj, ep = collect(*args, **kwargs)
            torch.cuda.synchronize()
            obs = traj["obs"]["obs"]
            rollouts.append({"ms": (time.perf_counter() - t0) * 1e3, "device": str(obs.device), "dtype": obs.dtype, "shape": tuple(obs.shape)})
            return traj, ep

        def timed_train(ts, traj, generator):
            step0 = ts.train_step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window["steps"] = 0
            out = train_fn(ts, traj, generator)
            torch.cuda.synchronize()
            calls.append({"ms": (time.perf_counter() - t0) * 1e3, "sgd_steps": ts.train_step - step0, "lr": ts.curr_lr,
                          "epochs": float(out["epochs_executed"]), "finite": all(bool(torch.isfinite(v).all()) for v in out.values())})
            return out

        def windowed_iteration():
            if len(rollouts) == 1:
                reset_slot_timers(runner.sampler)  # the per-slot host times of iterations 2 and 3
            if len(rollouts) == iters - 1:
                slots.update(slot_ms(runner.sampler), slots_timed=runner.sampler.slots_timed)
                window["prof"] = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                window["prof"].start()
            torch.cuda.synchronize()
            window["t0"] = time.perf_counter()
            return iteration()

        runner.sampler.collect_rollout, runner._train_fn, runner._train_iteration = timed_collect, timed_train, windowed_iteration

    argv = QUIET_HOST + ["--env=envpool_atari_breakout", f"--num_workers={workers}", "--num_envs_per_worker=32", "--worker_num_splits=2",
                         f"--train_for_env_steps={iters * envs * rollout * 4}", "--experiment=atari"]  # env steps count frames (frameskip 4)
    with standins_on_path("envpool"):
        runner, counts, stats, times = train(torch, cuda_rnn, argv, tmp, before_run, register_fn=atari.register_envpool_atari_components,
                                             parse=atari.parse_envpool_atari_args)
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == len(calls) == len(rollouts) == len(window["ms"]) == iters, f"{len(per_iter)} iterations, {len(calls)} train calls")
    check(all(v == 0 for v in counts.values()), f"an RNN kernel launched on the atari path: {counts}")
    check(all(r["device"] == "cuda:0" and r["dtype"] == torch.uint8 and r["shape"] == (rollout + 1, envs, 84, 84, 4) for r in rollouts),
          f"observations {rollouts[0]['device']} {rollouts[0]['dtype']} {rollouts[0]['shape']}")
    lrs = [runner.cfg.learning_rate] + [c["lr"] for c in calls]
    check(all(a > b for a, b in zip(lrs, lrs[1:])), f"the learning rate did not fall after each train call: {lrs}")
    check(all(c["finite"] for c in calls) and all(math.isfinite(v) for v in stats.values()), "non-finite losses")
    check(all(c["sgd_steps"] == c["epochs"] * epoch_steps for c in calls), f"sgd steps {[c['sgd_steps'] for c in calls]}")
    check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
    check(profile.get("device_us", 0) > 0 and profile["activities"] > 0, f"the profiler saw no device activity: {profile}")
    timed = per_iter[1:iters - 1]
    emit({"phase": "atari", "env": "envpool_atari_breakout (stand-in pool)", "workers": workers, "cpu_count": os.cpu_count(), "envs": envs,
          "splits": 2, "rollout": rollout, "iterations": iters, "env_steps_frames": runner.env_steps, "launches": counts, "iteration_s": per_iter,
          "env_steps_per_s_iterations_2_3": envs * rollout * len(timed) / sum(timed), "rollout_ms": [r["ms"] for r in rollouts],
          "learner_ms": [c["ms"] for c in calls], "sgd_steps_per_iteration": [c["sgd_steps"] for c in calls], "lr": lrs,
          "upload_bytes_per_iteration": (rollout + 1) * envs * ATARI_FRAME_BYTES, "slot_ms_host_clock_iterations_2_3": slots,
          "window": f"the rollout and the first epoch ({epoch_steps} SGD steps), host clock, synced", "window_ms": window["ms"],
          "profiled_window_iteration_4": {"wall_ms": profile["wall_ms"], "profiler_stop_s": profile["stop_s"],
                                          "device_busy_ms": profile["device_us"] / 1e3, "device_activities": profile["activities"],
                                          "top_device_ms": profile["top"],
                                          "device_idle_share_vs_unprofiled_window_3": 1.0 - profile["device_us"] / (window["ms"][2] * 1e3)},
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "timing": runner.timing.flat_str(), "card": card})
    return counts


@contextlib.contextmanager
def launch_shapes(cuda_rnn):
    """Record (kind, T, B, H) of each forward kernel launch while the block runs, `lstm_seq_in`'s fused kernel's too; the
    wrappers count as before."""
    seen, launch, launch_in = [], cuda_rnn._launch, cuda_rnn._launch_lstm_in

    def recording(kind, x_proj, *args):
        seen.append((kind, x_proj.shape[0], x_proj.shape[1], x_proj.shape[2] // (3 if kind == "gru" else 4)))
        return launch(kind, x_proj, *args)

    def recording_in(x, wi, bi, hc0, resets, wh, *args, **kwargs):
        seen.append(("lstm", x.shape[0], x.shape[1], wh.shape[0]))
        return launch_in(x, wi, bi, hc0, resets, wh, *args, **kwargs)

    cuda_rnn._launch, cuda_rnn._launch_lstm_in = recording, recording_in
    try:
        yield seen
    finally:
        cuda_rnn._launch, cuda_rnn._launch_lstm_in = launch, launch_in


@contextlib.contextmanager
def in_routes(cuda_rnn):
    """Record the way `lstm_seq_in` takes at each call while the block runs ((T, B, H, I) -> {route: calls})."""
    seen, route = {}, cuda_rnn.in_route

    def recording(device, T, B, H, I, dtype):
        way = route(device, T, B, H, I, dtype)
        by_way = seen.setdefault((T, B, H, I), {})
        by_way[way] = by_way.get(way, 0) + 1
        return way

    cuda_rnn.in_route = recording
    try:
        yield seen
    finally:
        cuda_rnn.in_route = route


def site_kernels(cuda_rnn, T, B, H, dtype, I=None):
    """The forward and backward kernels a site launches: lstm_seq_in's fused pair where `in_route` takes it (an LSTM with an
    input of width I), else the planned design's (`launch_plan`, `bwd_plan`)."""
    if I is not None and cuda_rnn.in_route("cuda", T, B, H, I, dtype) == "fused":
        return "lstm_seq_resident_in", "lstm_seq_resident_in_bwd"
    return (cuda_rnn._kernel_name("lstm", cuda_rnn.launch_plan("lstm", T, B, H, dtype, SPEC)),
            cuda_rnn._bwd_kernel_name("lstm", cuda_rnn.bwd_plan("lstm", B, H, dtype, SPEC)))


def host_workers(paper_workers, envs, splits=2):
    """The paper's worker count where the machine has a core for each, else the most workers (one a
    core) that keep all `envs` in equal splits: the env count is never cut."""
    cores = os.cpu_count() or 1
    for w in range(min(paper_workers, cores), 0, -1):
        if envs % w == 0 and (envs // w) % splits == 0:
            return w
    raise RuntimeError(f"no worker count divides {envs} envs")


def instrument_host_iterations(torch, runner, iters, record):
    """Per iteration (host clock, synced): the iteration, its rollout (with the learner quanta the
    pacer dispatches inside it) and the host time in quanta and in the flush; the per-slot times
    count from iteration 2; the last iteration runs under the profiler (CUDA activity only)."""
    q, sampler, iteration = runner._quantizer, runner.sampler, runner._train_iteration
    collect, dispatch_one, flush = sampler.collect_rollout, q.dispatch_one, q.flush
    learner = {"quanta": 0.0, "flush": 0.0}

    def clocked(key, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            learner[key] += time.perf_counter() - t0
            return out
        return call

    def timed_collect(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = collect(*args, **kwargs)
        torch.cuda.synchronize()
        record["rollout_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_iteration():
        k = len(record["iteration_ms"])
        if k == 1:
            reset_slot_timers(sampler)
        if k == iters - 1:
            record["slot_ms"] = dict(slot_ms(sampler), slots_timed=sampler.slots_timed)  # iterations 2 to N-1, unprofiled
        learner.update(quanta=0.0, flush=0.0)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) if k == iters - 1 else None
        if prof is not None:
            prof.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = iteration()
        torch.cuda.synchronize()
        record["iteration_ms"].append((time.perf_counter() - t0) * 1e3)
        record["learner_quanta_ms"].append(learner["quanta"] * 1e3)
        record["learner_flush_ms"].append(learner["flush"] * 1e3)
        if prof is not None:
            prof.stop()
            device_us, rnn_us, on_device, by_name = device_activities(prof)
            unprofiled_ms = record["iteration_ms"][-2]
            record["profile"] = {"profiled_iteration_ms": record["iteration_ms"][-1], "device_busy_ms": device_us / 1e3,
                                 "device_activities": len(on_device), "rnn_kernel_ms": rnn_us / 1e3,
                                 "device_idle_share_vs_unprofiled_iteration": 1.0 - device_us / (unprofiled_ms * 1e3),
                                 "top_device_ms": {k2: v / 1e3 for k2, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}}
        return out

    sampler.collect_rollout, runner._train_iteration = timed_collect, timed_iteration
    q.dispatch_one, q.flush = clocked("quanta", dispatch_one), clocked("flush", flush)


def host_example_line(runner, iters, record, envs):
    steady = record["iteration_ms"][1:]
    return {"iterations": iters, "env_steps_frames": runner.env_steps, "iteration_ms": record["iteration_ms"],
            "env_steps_per_s_iterations_2_on": envs * runner.cfg.rollout * len(steady) / (sum(steady) / 1e3),
            "rollout_ms": record["rollout_ms"], "learner_quanta_host_ms": record["learner_quanta_ms"],
            "learner_flush_host_ms": record["learner_flush_ms"], "slot_ms_host_clock_unprofiled_iterations_2_on": record["slot_ms"],
            "device_in_the_last_iteration": record["profile"],
            "stat": "host clock, synced; the rollout includes the learner quanta dispatched inside it; the last iteration "
                    "under torch.profiler (CUDA activity only), its busy time against the iteration before, unprofiled",
            "timing": runner.timing.flat_str()}


DOOM_ENVS, DOOM_PAPER_WORKERS, DOOM_ITERS = 400, 20, 4


def phase_doom(torch, cuda_rnn, card, tmp):
    """The paper's doom_battle command line (`sf_examples_tpu/vizdoom/experiments/doom_battle_appo.py`)
    through the port's `train_vizdoom` flags: doom_params, GRU-512 float32 (the cfg's defaults),
    convnet_simple over 72x128x3, the measurements MLP, the tuple head, 400 envs, batch 2048, async
    with the quantized learner; 4 iterations over the env-level stand-in of
    `tests/standins/doom_battle_standin.py` (the card's machine has neither gymnasium nor vizdoom)."""
    with restored_encoder_factory(), standins_on_path("doom_battle_standin"):
        return doom_run(torch, cuda_rnn, card, tmp)


def doom_run(torch, cuda_rnn, card, tmp):
    import doom_battle_standin as standin

    from sample_factory_tpu_torch.envs.spaces import TupleSpec
    from sample_factory_tpu_torch.examples.custom_encoders import VizdoomEncoder
    from sample_factory_tpu_torch.examples.vizdoom.train_vizdoom import parse_vizdoom_cfg

    workers = host_workers(DOOM_PAPER_WORKERS, DOOM_ENVS)
    cut = None if workers == DOOM_PAPER_WORKERS else f"{workers} workers x {DOOM_ENVS // workers} envs (paper: 20 x 20; {os.cpu_count()} cores)"
    if cut:
        print(f"doom: {cut}", flush=True)
    standin.register_doom_battle_standin()
    record = {"iteration_ms": [], "rollout_ms": [], "learner_quanta_ms": [], "learner_flush_ms": [], "slot_ms": {}, "profile": {}}

    def before_run(runner):
        cfg = runner.cfg
        check_host_example(runner, workers, VizdoomEncoder)
        check((cfg.rnn_type, cfg.rnn_size, cfg.compute_dtype, cfg.use_rnn, cfg.recurrence) == ("gru", 512, "float32", True, 32)
              and cfg.encoder_conv_architecture == "convnet_simple" and cfg.exploration_loss == "symmetric_kl" and cfg.normalize_input
              and cfg.normalize_returns and cfg.reward_scale == 0.5 and cfg.batch_size == 2048 and cfg.env_frameskip == 4
              and cfg.ppo_clip_value == 0.2, "not the paper's doom_battle configuration")
        check(runner.env_info.obs_space == standin.DoomBattleStandIn().observation_space
              and isinstance(runner.env_info.action_space, TupleSpec), f"spaces {runner.env_info.obs_space}")
        instrument_host_iterations(torch, runner, DOOM_ITERS, record)
        capture_train_steps(runner, captured)

    captured = {}
    argv = QUIET_HOST + ["--env=doom_battle", "--env_frameskip=4", "--use_rnn=True", "--reward_scale=0.5", f"--num_workers={workers}",
                         f"--num_envs_per_worker={DOOM_ENVS // workers}", "--batch_size=2048", "--wide_aspect_ratio=False",
                         f"--train_for_env_steps={DOOM_ITERS * DOOM_ENVS * 32 * 4}", "--experiment=doom"]  # env steps count frames
    with launch_shapes(cuda_rnn) as shapes:
        runner, counts, stats, _ = train(torch, cuda_rnn, argv, tmp, before_run, register_fn=standin.register_doom_battle_standin,
                                         parse=parse_vizdoom_cfg)
    minibatches = runner._quantizer.num_minibatches
    check(len(record["iteration_ms"]) == DOOM_ITERS, f"{len(record['iteration_ms'])} iterations")
    check(minibatches == DOOM_ENVS * 32 // 2048 and counts["gru_seq_grid"] == DOOM_ITERS * minibatches,
          f"gru_seq_grid launches {counts['gru_seq_grid']}, expected {DOOM_ITERS} train steps x {minibatches} minibatches")
    check(not any(others(counts, "gru_seq_grid").values()), f"other kernels launched on the doom path: {counts}")
    check_backward_launches(counts, "doom")
    check(set(shapes) == {("gru", *DOOM_GRU[:3])}, f"launch shapes {set(shapes)}")
    check(runner.episode_stats.avg_reward is not None, "no episode finished")
    check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
    emit({"phase": "doom", "env": "doom_battle (env-level stand-in)", "workers": workers, "envs": DOOM_ENVS, "cut": cut,
          "cpu_count": os.cpu_count(), "splits": runner.cfg.worker_num_splits, "rollout": 32, "batch": 2048, "model": "convnet_simple + "
          "measurements MLP, GRU-512 float32", "launches": counts, "launch_shapes": sorted(set(shapes)), "minibatches_per_train_step": minibatches,
          **host_example_line(runner, DOOM_ITERS, record, DOOM_ENVS), "avg_episode_reward": runner.episode_stats.avg_reward,
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    learner_turns(torch, cuda_rnn, runner, captured, "doom", card)
    return counts


DMLAB_ENVS, DMLAB_PAPER_WORKERS, DMLAB_ITERS = 128, 32, 4


def phase_dmlab(torch, cuda_rnn, card, tmp):
    """dmlab_30 at dmlab_params and the usage line of `docs/integrations/dmlab.md:20-21` (32 workers x
    4 envs, batch 1024): LSTM-256 over convnet_impala ++ the instruction encoder (embedding and
    LSTM-64 over 16 tokens), async with the quantized learner, 4 iterations. The envs are the port's
    own `DmlabEnv` (with its level cache in the run's directory, tokenization and reward clip) over the
    stand-in engine `tests/standins/deepmind_lab.py`; the DMLab-30 score tracker is registered as
    `train_dmlab.main` registers it."""
    with restored_encoder_factory(), standins_on_path("deepmind_lab"):
        return dmlab_run(torch, cuda_rnn, card, tmp)


def dmlab_run(torch, cuda_rnn, card, tmp):
    from sample_factory_tpu_torch.examples.custom_encoders import DmlabEncoder
    from sample_factory_tpu_torch.examples.dmlab import train_dmlab
    from sample_factory_tpu_torch.examples.dmlab.dmlab_summaries import TARGET_OBJECTIVE_STAT, Dmlab30ScoreTracker

    workers = host_workers(DMLAB_PAPER_WORKERS, DMLAB_ENVS)
    cut = None if workers == DMLAB_PAPER_WORKERS else f"{workers} workers x {DMLAB_ENVS // workers} envs (usage line: 32 x 4; {os.cpu_count()} cores)"
    if cut:
        print(f"dmlab: {cut}", flush=True)
    train_dmlab.register_dmlab_components()
    record = {"iteration_ms": [], "rollout_ms": [], "learner_quanta_ms": [], "learner_flush_ms": [], "slot_ms": {}, "profile": {}}
    episodes = {}

    class CountingTracker(Dmlab30ScoreTracker):
        def on_episode_extra_stats(self, runner, extra_stats, policy_id):
            for key in extra_stats:
                if key.endswith("_dmlab_raw_score"):
                    level = key[len("z_00_"):-len("_dmlab_raw_score")]
                    episodes[level] = episodes.get(level, 0) + 1
            super().on_episode_extra_stats(runner, extra_stats, policy_id)

    tracker = {}

    def before_run(runner):
        cfg = runner.cfg
        check_host_example(runner, workers, DmlabEncoder)
        check((cfg.rnn_type, cfg.rnn_size, cfg.compute_dtype, cfg.rollout, cfg.recurrence, cfg.batch_size, cfg.num_epochs)
              == ("lstm", 256, "float32", 32, 32, 1024, 1) and cfg.encoder_conv_architecture == "convnet_impala"
              and cfg.normalize_input_keys == ["obs"], "not dmlab_params")
        check(set(runner.train_state.obs_rms) == {"obs"}, "the instruction tokens are normalized")
        tracker["t"] = CountingTracker(cfg)  # as train_dmlab.main registers it
        runner.register_episodic_stats_handler(tracker["t"].on_episode_extra_stats)
        runner.register_observer(tracker["t"])
        instrument_host_iterations(torch, runner, DMLAB_ITERS, record)

    argv = QUIET_HOST + ["--env=dmlab_30", f"--num_workers={workers}", f"--num_envs_per_worker={DMLAB_ENVS // workers}",
                         f"--dmlab_level_cache_path={tmp}/dmlab_cache", f"--train_for_env_steps={DMLAB_ITERS * DMLAB_ENVS * 32 * 4}",
                         "--experiment=dmlab"]  # env steps count frames (frameskip 4)
    with launch_shapes(cuda_rnn) as shapes, in_routes(cuda_rnn) as routes:
        runner, counts, stats, _ = train(torch, cuda_rnn, argv, tmp, before_run, register_fn=train_dmlab.register_dmlab_components,
                                         parse=train_dmlab.parse_dmlab_args)
    cfg, minibatches = runner.cfg, runner._quantizer.num_minibatches
    split = DMLAB_ENVS // cfg.worker_num_splits
    # the core (learner minibatches); the instruction encoder in a rollout slot, in a learner minibatch,
    # and in the learner's value of each env's last observation (prepare, once a train step)
    sites = {"core": ("lstm", *DMLAB_CORE[:3]), "instruction_rollout": ("lstm", *DMLAB_INSTR_ROLLOUT[:3]),
             "instruction_learner": ("lstm", *DMLAB_INSTR_LEARNER[:3]), "instruction_learner_last_value": ("lstm", *DMLAB_INSTR_BOOTSTRAP[:3])}
    by_site = {site: shapes.count(shape) for site, shape in sites.items()}
    check(len(record["iteration_ms"]) == DMLAB_ITERS and minibatches == 4 and split == DMLAB_INSTR_ROLLOUT[1], f"{minibatches} minibatches")
    check(by_site["core"] == by_site["instruction_learner"] == DMLAB_ITERS * minibatches
          and by_site["instruction_learner_last_value"] == DMLAB_ITERS, f"learner launches by site {by_site}")
    check(by_site["instruction_rollout"] >= DMLAB_ITERS * cfg.rollout * cfg.worker_num_splits, f"rollout launches by site {by_site}")
    # each site's launches go to its route (the instruction encoder: lstm_seq_in's fused kernel) or the design its plan picks
    # (the core); the backward once for each learner minibatch's forward (the core and the instruction encoder), the rollout
    # and the value of the last observation running under no_grad
    kernels = {site: site_kernels(cuda_rnn, T, B, H, torch.float32, None if site == "core" else DMLAB_INSTRUCTION_EMBED)
               for site, (_, T, B, H) in sites.items()}
    expected = dict.fromkeys(counts, 0)
    for site, (fwd_name, bwd_name) in kernels.items():
        expected[fwd_name] += by_site[site]
        if site in ("core", "instruction_learner"):
            expected[bwd_name] += by_site[site]
    check(sum(by_site.values()) == len(shapes) and counts == expected, f"launches {counts} against {expected}, shapes {set(shapes)}")
    # the instruction encoder in one launch each way: the fused forward at every site (on the H100 SXM; a smaller card may plan
    # otherwise), its backward once for each learner forward, no call on the Linear + lstm_seq route, and no resident kernel
    # of the unfused route; the row design on no path
    on_sxm = SPEC == cuda_rnn.H100_SXM
    instruction = {shape: ways for shape, ways in routes.items() if shape[3] == DMLAB_INSTRUCTION_EMBED}
    check(counts["lstm_seq_resident_in"] >= by_site["instruction_learner"] and counts["lstm_seq_resident_in_bwd"] == by_site["instruction_learner"]
          and (not on_sxm or (counts["lstm_seq_resident_in"] == sum(by_site.values()) - by_site["core"]
                              and counts["lstm_seq_resident"] == counts["lstm_seq_resident_bwd"] == 0
                              and all(set(ways) == {"fused"} for ways in instruction.values()))),
          f"the instruction encoder's launches {counts}, routes {routes}")
    check(counts["lstm_seq_rows"] == counts["lstm_seq_bwd"] == 0, f"the row design ran: {counts}")
    SITE_LAUNCHES["dmlab"] = {site: {"kernel": kernels[site][0], "launches": by_site[site]} for site in sites}
    check(sum(episodes.values()) > 0 and not shm_segments(), f"episodes {episodes}, segments {shm_segments()}")
    cache = os.path.join(tmp, "dmlab_cache")
    emit({"phase": "dmlab", "env": "dmlab_30 (DmlabEnv over the stand-in engine)", "workers": workers, "envs": DMLAB_ENVS, "cut": cut,
          "cpu_count": os.cpu_count(), "splits": cfg.worker_num_splits, "rollout": 32, "batch": 1024,
          "model": "convnet_impala ++ instruction embedding + LSTM-64, LSTM-256 float32", "launches": counts,
          "lstm_seq_launches_by_site": by_site, "lstm_seq_in_routes": {str(list(k)): v for k, v in routes.items()},
          "minibatches_per_train_step": minibatches,
          **host_example_line(runner, DMLAB_ITERS, record, DMLAB_ENVS), "episodes_by_task": episodes, "tasks_seen": len(episodes),
          "dmlab_target_objective": [list(d) for d in runner.policy_avg_stats.get(TARGET_OBJECTIVE_STAT, [])],
          "level_cache_maps": len(os.listdir(os.path.join(cache, "maps"))) if os.path.isdir(os.path.join(cache, "maps")) else 0,
          "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
    return counts


NETHACK_ENVS, NETHACK_PAPER_WORKERS, NETHACK_ITERS, SCALEDNET_ITERS = 24, 12, 4, 2
NETHACK_EXTRA_STATS = {"score", "turns", "dlvl", "max_hitpoints", "max_energy", "armor_class", "experience_level", "experience_points",
                       "eating_score", "gold_score", "scout_score", "sokoban_fill_pit_score", "sokoban_reached_score",
                       "staircase_pet_score", "staircase_score"}


def phase_nethack(torch, cuda_rnn, card, tmp):
    """nethack_challenge through `train_nethack`'s flags at their defaults (nethack_params: LSTM-512
    float32, batch 1024, rollout 32, one epoch of one minibatch, async with the quantized learner,
    normalized returns, reward clip 10; 12 workers x 2 envs in 2 splits): ChaoticDwarvenGPT5 over the
    108x108x2 screen image for 4 iterations, then ScaledNet at its defaults (h_dim 1738, the crop
    branch, GroupNorm) for 2, over the env-level stand-in of `tests/standins/nethack_standin.py` (the
    card's machine has neither gymnasium nor nle)."""
    with restored_encoder_factory(), standins_on_path("nethack_standin", "nethack_sim", "nle", "nle.nethack"):
        return nethack_run(torch, cuda_rnn, card, tmp)


def nethack_run(torch, cuda_rnn, card, tmp):
    import nethack_standin as standin

    from sample_factory_tpu_torch.examples.nethack.models import ChaoticDwarvenGPT5, ScaledNet
    from sample_factory_tpu_torch.examples.nethack.train_nethack import parse_nethack_args

    workers = host_workers(NETHACK_PAPER_WORKERS, NETHACK_ENVS)
    cut = None if workers == NETHACK_PAPER_WORKERS else f"{workers} workers x {NETHACK_ENVS // workers} envs (defaults: 12 x 2; {os.cpu_count()} cores)"
    if cut:
        print(f"nethack: {cut}", flush=True)
    standin.register_nethack_standin()
    total = {}
    for model, encoder_cls, iters in (("ChaoticDwarvenGPT5", ChaoticDwarvenGPT5, NETHACK_ITERS), ("ScaledNet", ScaledNet, SCALEDNET_ITERS)):
        record = {"iteration_ms": [], "rollout_ms": [], "learner_quanta_ms": [], "learner_flush_ms": [], "slot_ms": {}, "profile": {}}
        extras = {"episodes": 0, "keys": set()}

        def on_extra_stats(runner, extra_stats, policy_id):
            extras["episodes"] += 1
            extras["keys"] |= set(extra_stats)

        def before_run(runner):
            cfg = runner.cfg
            check_host_example(runner, workers, encoder_cls)
            check((cfg.rnn_type, cfg.rnn_size, cfg.compute_dtype, cfg.use_rnn, cfg.rollout, cfg.recurrence, cfg.batch_size, cfg.num_epochs,
                   cfg.num_batches_per_epoch) == ("lstm", 512, "float32", True, 32, 32, 1024, 1, 1) and cfg.normalize_returns
                  and not cfg.normalize_input and cfg.reward_clip == 10.0 and cfg.crop_dim == 18 and cfg.pixel_size == 6
                  and (model == "ChaoticDwarvenGPT5" or (cfg.h_dim, cfg.use_crop, cfg.use_crop_norm) == (1738, True, True)),
                  "not the NetHack defaults")
            check(runner.env_info.obs_space == standin.NetHackStandIn().observation_space, f"spaces {runner.env_info.obs_space}")
            runner.register_episodic_stats_handler(on_extra_stats)
            instrument_host_iterations(torch, runner, iters, record)

        argv = QUIET_HOST + ["--env=nethack_challenge", f"--model={model}", f"--num_workers={workers}",
                             f"--num_envs_per_worker={NETHACK_ENVS // workers}", f"--train_for_env_steps={iters * NETHACK_ENVS * 32}",
                             f"--experiment=nethack_{model}"]
        with launch_shapes(cuda_rnn) as shapes:
            runner, counts, stats, _ = train(torch, cuda_rnn, argv, tmp, before_run, register_fn=standin.register_nethack_standin,
                                             parse=parse_nethack_args)
        minibatches = runner._quantizer.num_minibatches
        check(len(record["iteration_ms"]) == iters and minibatches == 1, f"{len(record['iteration_ms'])} iterations, {minibatches} minibatches")
        check(counts["lstm_seq_grid"] == iters and not any(others(counts, "lstm_seq_grid").values()),
              f"launches {counts}: expected one lstm_seq_grid a train step and no other kernel")
        check_backward_launches(counts, f"nethack {model}")
        check(set(shapes) == {("lstm", *NETHACK_LSTM[:3])}, f"launch shapes {set(shapes)}")
        check(extras["episodes"] > 0 and extras["keys"] == NETHACK_EXTRA_STATS, f"episode extra stats {extras}")
        check(not shm_segments(), f"shared-memory segments left behind: {shm_segments()}")
        profile = record["profile"]
        emit({"phase": "nethack", "env": "nethack_challenge (env-level stand-in)", "model": f"{model}, LSTM-512 float32",
              "workers": workers, "envs": NETHACK_ENVS, "cut": cut, "cpu_count": os.cpu_count(), "splits": runner.cfg.worker_num_splits,
              "rollout": 32, "batch": runner._quantizer.batch_size, "launches": counts, "launch_shapes": sorted(set(shapes)),
              "grid_design_share_of_device_busy": profile["rnn_kernel_ms"] / profile["device_busy_ms"],
              **host_example_line(runner, iters, record, NETHACK_ENVS), "episodes_with_extra_stats": extras["episodes"],
              "extra_stat_keys": sorted(extras["keys"]), "avg_episode_reward": runner.episode_stats.avg_reward,
              "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    return total


IG_TASKS = (("Ant", 4096, 60, 4), ("AllegroHandLSTM", 16384, 88, 2))  # task, sim agents (IGE's default), obs width, iterations


def instrument_sync_iterations(torch, runner, iters, record):
    """Per iteration of the sync host runner (host clock, synced): the iteration, its rollout and its
    train call, the epochs the train call ran; the last iteration under the profiler (CUDA activity
    only), its busy time against the iteration before, unprofiled."""
    sampler, iteration, train_fn = runner.sampler, runner._train_iteration, runner._train_fn

    def clocked(key, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record[key].append((time.perf_counter() - t0) * 1e3)
            if key == "train_ms":
                record["epochs"].append(float(out["epochs_executed"]))
            return out
        return call

    def timed_iteration():
        last = len(record["iteration_ms"]) == iters - 1
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) if last else None
        if prof is not None:
            prof.start()
        out = clocked("iteration_ms", iteration)()
        if prof is not None:
            prof.stop()
            device_us, rnn_us, on_device, _ = device_activities(prof)
            record["profile"] = {"device_busy_ms": device_us / 1e3, "device_activities": len(on_device), "rnn_kernel_ms": rnn_us / 1e3,
                                 "device_idle_share_vs_unprofiled_iteration": 1.0 - device_us / (record["iteration_ms"][-2] * 1e3)}
        return out

    sampler.collect_rollout, runner._train_fn = clocked("rollout_ms", sampler.collect_rollout), clocked("train_ms", train_fn)
    runner._train_iteration = timed_iteration


def phase_isaacgym(torch, cuda_rnn, card, tmp):
    """`train_isaacgym` at its per-task defaults (serial mode, sync, rollout 16, batch 32768, 4 epochs,
    kl_adaptive_epoch) over the stand-ins of `isaacgym`, `isaacgymenvs` and `hydra` in
    `tests/standins/`, whose sim steps batched torch dynamics on cuda:0: Ant (MLP 256-128-64 elu,
    4096 sim agents, 2 minibatches) for 4 iterations, then AllegroHandLSTM (its sim states, LSTM-512
    float32, 16384 sim agents, 8 minibatches) for 2. The sim's tensors come to host numpy each step,
    as the JAX adapter's do."""
    with restored_encoder_factory(), standins_on_path("isaacgymenvs", "isaacgymenvs.tasks", "isaacgymenvs.utils",
                                                       "isaacgymenvs.utils.reformat", "hydra", "hydra.core", "hydra.core.global_hydra"):
        return isaacgym_run(torch, cuda_rnn, card, tmp)


def isaacgym_run(torch, cuda_rnn, card, tmp):
    from isaacgymenvs.tasks import StandInVecTask

    from sample_factory_tpu_torch.examples.isaacgym_examples import train_isaacgym as ig

    check("isaacgym" in sys.modules and ig.isaacgym_available(), "isaacgym is not importable")
    ig.register_isaacgym_components()
    clock = {"adapter_step_s": 0.0, "sim_step_s": 0.0, "steps": 0}
    adapter_step, sim_step = ig.IsaacGymBatchedEnv.step, StandInVecTask.step

    def timed_adapter_step(self, action_list):
        t0 = time.perf_counter()
        out = adapter_step(self, action_list)
        clock["adapter_step_s"] += time.perf_counter() - t0
        clock["steps"] += 1
        return out

    def timed_sim_step(self, actions):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sim_step(self, actions)
        torch.cuda.synchronize()
        clock["sim_step_s"] += time.perf_counter() - t0
        return out

    ig.IsaacGymBatchedEnv.step, StandInVecTask.step = timed_adapter_step, timed_sim_step
    total = {}
    try:
        for task, agents, width, iters in IG_TASKS:
            record = {"iteration_ms": [], "rollout_ms": [], "train_ms": [], "epochs": [], "profile": {}}
            lstm = task == "AllegroHandLSTM"

            def before_run(runner):
                cfg = runner.cfg
                check(runner.device.type == "cuda", "the runner is not on the card")
                check(type(runner).__name__ == "HostEnvRunner" and runner.sampler.transport == "serial" and not cfg.async_rl
                      and runner._quantizer is None, "not the serial sync host runner")
                check((cfg.rollout, cfg.batch_size, cfg.num_epochs, cfg.lr_schedule, cfg.use_rnn, cfg.num_envs)
                      == (16, 32768, 4, "kl_adaptive_epoch", lstm, agents), f"not {task}'s configuration")
                check(lstm or (cfg.encoder_mlp_layers == [256, 128, 64] and cfg.num_batches_per_epoch == 2), "not Ant's configuration")
                check(not lstm or ((cfg.rnn_type, cfg.rnn_size, cfg.compute_dtype, cfg.obs_key, cfg.num_batches_per_epoch)
                                   == ("lstm", 512, "float32", "states", 8)), "not AllegroHandLSTM's configuration")
                check(runner.env_info.obs_space["obs"].shape == (width,) and runner.env_info.num_agents == agents, f"spaces {runner.env_info}")
                check({str(p.device) for p in runner.model.parameters()} == {"cuda:0"}, "the model is not on cuda:0")
                clock.update(adapter_step_s=0.0, sim_step_s=0.0, steps=0)
                instrument_sync_iterations(torch, runner, iters, record)

            argv = QUIET + [f"--env={task}", f"--train_for_env_steps={iters * agents * 16}", f"--experiment=isaacgym_{task}"]
            with launch_shapes(cuda_rnn) as shapes:
                runner, counts, stats, _ = train(torch, cuda_rnn, argv, tmp, before_run, register_fn=ig.register_isaacgym_components,
                                                 parse=ig.parse_isaacgym_args)
            epochs = record["epochs"]
            check(len(record["iteration_ms"]) == iters and len(epochs) == iters, f"{len(record['iteration_ms'])} iterations")
            if lstm:
                check(counts["lstm_seq_grid"] == 8 * sum(epochs) and not any(others(counts, "lstm_seq_grid").values()),
                      f"launches {counts}: expected 8 lstm_seq_grid an epoch ({epochs})")
                check_backward_launches(counts, "isaacgym")
                check(set(shapes) == {("lstm", *ALLEGRO_LSTM[:3])}, f"launch shapes {set(shapes)}")
            else:
                check(all(v == 0 for v in counts.values()), f"an RNN kernel launched on the feed-forward path: {counts}")
            steady = record["iteration_ms"][1:]
            profile = record["profile"]
            emit({"phase": "isaacgym", "task": task, "sim": "stand-in batched torch dynamics on cuda:0 (tests/standins/isaacgymenvs)",
                  "sim_agents": agents, "obs_width": width, "rollout": 16, "batch": 32768, "iterations": iters, "launches": counts,
                  "launch_shapes": sorted(set(shapes)), "epochs_executed": epochs, "iteration_ms": record["iteration_ms"],
                  "rollout_ms": record["rollout_ms"], "train_ms": record["train_ms"],
                  "agent_steps_per_s_iterations_2_on": agents * 16 * len(steady) / (sum(steady) / 1e3),
                  "adapter_step_ms": clock["adapter_step_s"] / clock["steps"] * 1e3, "sim_step_ms": clock["sim_step_s"] / clock["steps"] * 1e3,
                  "host_conversion_ms_per_step": (clock["adapter_step_s"] - clock["sim_step_s"]) / clock["steps"] * 1e3,
                  "device_in_the_last_iteration": profile,
                  "lstm_kernel_share_of_device_busy": profile["rnn_kernel_ms"] / profile["device_busy_ms"],
                  "episodes_reported": runner.episode_stats.avg_reward is not None,
                  "stat": "host clock, synced; adapter step: the IsaacGymBatchedEnv.step call (sim step, the tensors to numpy, the "
                          "per-agent lists), the sim step synced on its own; the last iteration under torch.profiler (CUDA activity only)",
                  "loss": stats["loss"], "grad_norm": stats["grad_norm"], "card": card})
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
    finally:
        ig.IsaacGymBatchedEnv.step, StandInVecTask.step = adapter_step, sim_step
    return total


SAMPLER_STEPS = 200_000


def phase_sampler(torch, card, tmp):
    """`examples/sampler/use_simplified_sampling_api.generate_trajectories` on its fallback (no ALE
    here): the synthetic on-device env at train_synthetic's defaults, on the card."""
    from sample_factory_tpu_torch.algo.sampling_api import SyncSamplingAPI
    from sample_factory_tpu_torch.examples.sampler import use_simplified_sampling_api as sampler

    parse, register = sampler._components()
    check(register.__module__ == "sample_factory_tpu_torch.examples.train_synthetic", f"the sampler took {register.__module__}, not the fallback")
    register()
    cfg = parse(["--env=synthetic_vector_discrete", "--experiment=sampler", f"--train_dir={tmp}", "--device=gpu", "--seed=0"])
    shapes, collect = [], SyncSamplingAPI.get_trajectories_sync

    def recording_collect(self):
        traj = collect(self)
        shapes.append(({str(v.device) for k, v in traj.items() if k != "obs"}, tuple(traj["rewards"].shape)))
        return traj

    SyncSamplingAPI.get_trajectories_sync = recording_collect
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        check(sampler.generate_trajectories(cfg, register, SAMPLER_STEPS) == 0, "generate_trajectories failed")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    finally:
        SyncSamplingAPI.get_trajectories_sync = collect
    per_call = cfg.num_envs * cfg.rollout
    check(all(devices == {"cuda:0"} and shape == (cfg.rollout, cfg.num_envs) for devices, shape in shapes), f"trajectories {shapes[:2]}")
    check(len(shapes) == -(-SAMPLER_STEPS // per_call), f"{len(shapes)} calls of {per_call} samples for {SAMPLER_STEPS}")
    emit({"phase": "sampler", "env": cfg.env, "envs": cfg.num_envs, "rollout": cfg.rollout, "calls": len(shapes), "samples_per_call": per_call,
          "env_steps": len(shapes) * per_call, "seconds": seconds, "env_steps_per_s": len(shapes) * per_call / seconds,
          "stat": "host clock around generate_trajectories (start, the calls, stop), synced", "card": card})


DP_TOL = 1e-6  # float32 on the card, two ranks against one: each sum of the learner in another order
DP_STATS = ("loss", "policy_loss", "value_loss", "kl_divergence", "grad_norm", "adv_mean", "adv_std", "valids_fraction")
DP_STATS_TOL = 1e-5  # relative to max(1, |one rank's value|)
DP_ACTIONS_EQUAL = 0.999  # share of the sharded rollout's actions equal to the one-rank rollout's rows
DP2 = COMMON + ["--rnn_type=gru", "--compute_dtype=float32", "--batch_size=16384", "--num_envs=1024", "--shuffle_minibatches=True",
                "--train_for_env_steps=32768", "--experiment=dp2"]  # `main` in float32, one sync GAE iteration: 2 minibatches


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def full_precision(torch):
    """Float32 products in float32 (TF32 keeps ~3 digits), in every process that compares."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


DP_TURNS = ("nccl", "nogroup", "nogroup", "nccl")
# a fresh process's first conv and learner calls are slow (1.4-1.5 s an iteration of `host` against 0.32-0.38 s
# after, on an H100 80GB HBM3 at 700 W): the host path's turns start after an uncounted run without a group
DP_HOST_TURNS = ("warmup",) + DP_TURNS


def dp_child(mode, out_path, train_dir, traj_path=None):
    """A child of phase `dp` or `dp_host`: `turns` / `host_turns` (under torch.distributed.run: `main` /
    `host` in a world of 1 over NCCL in turns with the same run without a group, DP_TURNS, the group
    joined and left for each run; DP_HOST_TURNS for `host`), `gloo` / `host_gloo` (a rank of two on cuda:0), or of phase
    `tp`: `tp_gloo` (a rank of a 1 x 2 mesh on cuda:0) / `tp_multichip` (a rank of four on cuda:0). Imports nothing
    of JAX; writes its result as JSON to `out_path`."""
    import torch

    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.examples.train_synthetic import register_synthetic_components
    from sample_factory_tpu_torch.ops import cuda_rnn
    from sample_factory_tpu_torch.parallel import multihost

    check(torch.cuda.is_available(), "the dp child found no card")
    register_synthetic_components()
    register_bench_pixel()
    full_precision(torch)
    cuda_rnn.load_library()
    try:
        if mode == "gloo":
            out = dp_gloo_rank(torch, cuda_rnn, train_dir, traj_path)
        elif mode == "tp_gloo":
            out = tp_gloo_rank(torch, cuda_rnn, train_dir, traj_path)
        elif mode == "tp_multichip":
            out = tp_multichip_rank(torch, cuda_rnn, train_dir)
        elif mode == "host_gloo":
            out = dp_host_gloo_rank(torch, cuda_rnn, train_dir)
        else:
            rate_run, turns = (dp_host_rate_run, DP_HOST_TURNS) if mode == "host_turns" else (dp_rate_run, DP_TURNS)
            out = []
            for k, run in enumerate(turns):
                # the profiler's tracing slows the host's launches for the rest of the process: the last run alone
                out.append(rate_run(torch, cuda_rnn, run, train_dir, f"dp_{k}_{run}", profile=k == len(turns) - 1))
                multihost.shutdown()
    finally:
        multihost.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def dp_rate_run(torch, cuda_rnn, mode, train_dir, experiment, profile):
    """`main`'s configuration for 3 iterations through make_rl_runner (with --jax_distributed=True
    when `mode` is `nccl`), then, with `profile`, one more iteration under the profiler for the NCCL
    kernels' device time. NCCL may reduce in place without a kernel on one rank: the all-reduce calls
    are counted too."""
    import torch.distributed as dist

    iters, envs = 3, 1024
    argv = COMMON + MAIN_MODEL + [f"--num_envs={envs}", f"--train_for_env_steps={iters * envs * 32}", f"--experiment={experiment}"]
    calls, all_reduce = [], dist.all_reduce

    def counting_all_reduce(*args, **kwargs):
        calls.append(1)
        return all_reduce(*args, **kwargs)

    def one_iteration():
        stats, ep_stats = runner._train_iteration()
        runner._process_stats(stats, ep_stats)  # under a group: the iteration's all-reduce of the episode sums and the stop

    dist.all_reduce = counting_all_reduce
    try:
        runner, counts, stats, times = train(torch, cuda_rnn, argv + (["--jax_distributed=True"] if mode == "nccl" else []), train_dir)
        calls_in_run = len(calls)
        profiled = profiled_device_time(one_iteration) if profile else None
    finally:
        dist.all_reduce = all_reduce
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == iters, f"{mode}: expected {iters} iterations, ran {len(per_iter)}")
    check(runner.mesh.distributed == (mode == "nccl") and runner.mesh.world == 1, f"{mode}: mesh {runner.mesh}")
    check(calls_in_run > 0 if mode == "nccl" else not calls, f"{mode}: {len(calls)} all-reduces")
    if mode == "nccl":
        check(dist.get_backend() == "nccl" and runner.device == torch.device("cuda", 0), f"backend {dist.get_backend()}, device {runner.device}")
    ckpts = sorted(f for f in os.listdir(os.path.join(train_dir, experiment, "checkpoint_p0")) if f.startswith("checkpoint_"))
    check(ckpts == [f"checkpoint_{2 * iters:012d}_{iters * envs * 32}.pth"], f"{mode}: checkpoints {ckpts}, expected the final one alone")
    out = {"mode": mode, "iteration_s": per_iter, "env_steps_per_s_steady": envs * 32 * (iters - 1) / sum(per_iter[1:]),
           "launches": counts, "gru_seq_per_iteration": counts["gru_seq"] / iters, "checkpoints": ckpts, "loss": stats["loss"],
           "all_reduce_calls": {"run": calls_in_run, "profiled_iteration": len(calls) - calls_in_run}}
    if profiled is not None:
        wall_us, device_us, _, on_device, _ = profiled
        nccl = [e for e in on_device if "nccl" in e.name.lower()]
        out["profiled_iteration"] = {"device_busy_ms": device_us / 1e3, "wall_ms": wall_us / 1e3, "nccl_kernels": len(nccl),
                                     "nccl_ms": sum(e.time_range.elapsed_us() for e in nccl) / 1e3,
                                     "nccl_names": sorted({e.name[:60] for e in nccl})}
    return out


def dp_gloo_rank(torch, cuda_rnn, train_dir, traj_path):
    """One of two gloo ranks on cuda:0 (LOCAL_RANK=0 in both: NCCL refuses two ranks on one card):
    its sharded rollout, then the train call on its rows of the one-rank trajectory."""
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.parallel import multihost
    from sample_factory_tpu_torch.train import make_rl_runner

    multihost.init_distributed(backend="gloo")
    _, runner = make_rl_runner(parse_custom_args(DP2 + [f"--train_dir={train_dir}", "--device=gpu", "--seed=0", "--jax_distributed=True"]))
    runner.init()
    shard, ts = runner.sampler_state.shard, runner.train_state
    check(runner.device == torch.device("cuda", 0) and shard.size == 512, f"rank on {runner.device}, envs {shard}")
    _, own, _ = runner._rollout_fn(ts.model, ts.obs_rms, runner.sampler_state, ts.train_step, runner.policy_id)
    whole = torch.load(traj_path, map_location=runner.device)

    def rows(x):
        return {k: rows(v) for k, v in x.items()} if isinstance(x, dict) else x[:, shard.start : shard.stop]

    mine = rows(whole)
    torch.cuda.synchronize()
    cuda_rnn.reset_launch_counts()
    stats = runner._train_fn(ts, mine, runner.train_generator)
    torch.cuda.synchronize()
    counts = cuda_rnn.launch_counts()
    params_path = os.path.join(train_dir, f"rank{runner.mesh.rank}.pt")
    torch.save({k: v.cpu() for k, v in ts.model.state_dict().items()}, params_path)
    return {"rank": runner.mesh.rank, "shard": [shard.start, shard.stop], "launches": counts, "params": params_path,
            "reset_rows_equal": bool(torch.equal(own["obs"]["obs"][0], mine["obs"]["obs"][0])),
            "rollout_actions_equal_share": float((own["actions"] == mine["actions"]).float().mean()),
            "stats": {k: float(stats[k]) for k in DP_STATS}, "train_step": ts.train_step}


def run_child(cmd, env, out_path, timeout=300):
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(out.returncode == 0, f"{' '.join(cmd[:6])} failed ({out.returncode}):\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    with open(out_path) as f:
        return json.load(f)


def phase_dp(torch, cuda_rnn, card, tmp):
    """Data parallelism (`parallel/`). (a) `main` at full width in a world of 1 over NCCL, under
    torch.distributed.run through the port's train.py with --jax_distributed=True, in turns with the
    same run without a group (DP_TURNS, one child process): env steps/s, the all-reduces and the NCCL
    kernels' device time an iteration, GRU launches, one checkpoint. (b) two gloo ranks of 512 envs on cuda:0 against one
    rank of 1024 in float32: the parameters after the train call within DP_TOL, the replicas equal."""
    script = os.path.abspath(__file__)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(script) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("WORLD_SIZE", None)
    start = time.perf_counter()
    out_path = os.path.join(tmp, "dp_turns.json")
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1"]
    runs = run_child(launch + [script, "--dp-child", "turns", out_path, os.path.join(tmp, "dp_turns")], env, out_path)
    check([r["mode"] for r in runs] == list(DP_TURNS), f"runs {[r['mode'] for r in runs]}")
    for r in runs:
        check(r["gru_seq_per_iteration"] == 2, f"{r['mode']}: {r['gru_seq_per_iteration']} GRU launches an iteration, expected 2")
        check_backward_launches(r["launches"], f"dp {r['mode']}")
    profiled = runs[-1]["profiled_iteration"]
    runs = [(r["mode"], r) for r in runs]
    rate = {mode: [r["env_steps_per_s_steady"] for m, r in runs if m == mode] for mode in ("nccl", "nogroup")}
    emit({"phase": "dp", "leg": "nccl_world_of_1", "config": "main (grid_battle, convnet_impala, GRU-256 bf16, 1024 envs, rollout 32, batch 16384)",
          "turns": [m for m, _ in runs], "env_steps_per_s_steady": rate,
          "ratio_group_over_no_group": statistics.mean(rate["nccl"]) / statistics.mean(rate["nogroup"]),
          "profiled_iteration_of_the_last_group_run": profiled,
          "all_reduce_calls": {f"{k}_{m}": r["all_reduce_calls"] for k, (m, r) in enumerate(runs)},
          "gru_seq_per_iteration": [r["gru_seq_per_iteration"] for _, r in runs], "checkpoints": runs[0][1]["checkpoints"],
          "iteration_s": {f"{k}_{m}": r["iteration_s"] for k, (m, r) in enumerate(runs)}, "seconds": time.perf_counter() - start, "card": card})

    # (b) the one-rank reference: its rollout goes to the ranks, which train on their rows of it
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.train import make_rl_runner

    start_b = time.perf_counter()
    one_dir = os.path.join(tmp, "dp2_one")
    _, one = make_rl_runner(parse_custom_args(DP2 + [f"--train_dir={one_dir}", "--device=gpu", "--seed=0"]))
    one.init()
    ts = one.train_state
    _, traj, _ = one._rollout_fn(ts.model, ts.obs_rms, one.sampler_state, ts.train_step, one.policy_id)
    traj_path = os.path.join(tmp, "dp2_trajectory.pt")
    torch.save(traj, traj_path)
    port = free_port()
    procs = []
    for rank in (0, 1):
        rank_env = dict(env, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        out_path = os.path.join(tmp, f"dp2_rank{rank}.json")
        cmd = [sys.executable, script, "--dp-child", "gloo", out_path, os.path.join(tmp, "dp2"), traj_path]
        procs.append((subprocess.Popen(cmd, env=rank_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out_path))
    full_precision(torch)
    one_stats = one._train_fn(ts, traj, one.train_generator)  # meanwhile, the reference train call
    one_stats = {k: float(one_stats[k]) for k in DP_STATS}
    want = {k: v.cpu() for k, v in ts.model.state_dict().items()}
    ranks = []
    for proc, out_path in procs:
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
        check(proc.returncode == 0, f"a gloo rank failed ({proc.returncode}):\n{stdout[-2000:]}\n{stderr[-4000:]}")
        with open(out_path) as f:
            ranks.append(json.load(f))
    got = [torch.load(r["params"]) for r in ranks]
    diff = max(float((g[k] - v).abs().max()) for g in got for k, v in want.items())
    identical = all(bool(torch.equal(got[0][k], got[1][k])) for k in want)
    stats_err = {k: max(abs(r["stats"][k] - v) / max(1.0, abs(v)) for r in ranks) for k, v in one_stats.items()}
    check(all(r["reset_rows_equal"] for r in ranks), "a rank's reset observations differ from its rows of the one-rank reset")
    shares = [r["rollout_actions_equal_share"] for r in ranks]
    check(min(shares) >= DP_ACTIONS_EQUAL, f"the ranks' rollout actions equal the one-rank rollout's rows at {shares} < {DP_ACTIONS_EQUAL}")
    check(max(stats_err.values()) <= DP_STATS_TOL, f"two ranks' train stats against one rank's: {stats_err} > {DP_STATS_TOL}")
    check(identical, "the two ranks' replicas differ after the train call")
    check(diff <= DP_TOL, f"two ranks against one rank: max |param diff| {diff} > {DP_TOL}")
    check(all(r["launches"]["gru_seq"] == 2 for r in ranks), f"a rank did not launch the GRU kernel once a minibatch: {[r['launches'] for r in ranks]}")
    for r in ranks:
        check_backward_launches(r["launches"], f"dp rank {r['rank']}")
    check(ranks[0]["train_step"] == ranks[1]["train_step"] == ts.train_step == 2, "train steps differ")
    emit({"phase": "dp", "leg": "gloo_two_ranks_on_cuda0", "config": "main in float32, 1 sync GAE iteration, 2 shuffled minibatches of 16384",
          "max_abs_param_diff": diff, "tol": DP_TOL, "replicas_identical": identical,
          "stats_rel_err": stats_err, "stats_tol": DP_STATS_TOL, "stats_one_rank": one_stats,
          "shards": [r["shard"] for r in ranks], "reset_rows_equal": [r["reset_rows_equal"] for r in ranks],
          "rollout_actions_equal_share": shares, "actions_equal_min": DP_ACTIONS_EQUAL,
          "gru_seq_by_rank": [r["launches"]["gru_seq"] for r in ranks],
          "seconds": time.perf_counter() - start_b, "card": card})
    del one
    counts_a = [r["launches"] for m, r in runs if m == "nccl"]
    return ({k: sum(c[k] for c in counts_a) for k in counts_a[0]},
            {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]})


# phase `tp`: tensor parallelism over the 'model' axis, gloo ranks on cuda:0 (NCCL takes one rank a card)
TP_TOL = 1e-6  # float32 on the card, a 1 x 2 mesh against one rank: x @ wi split by columns, wh gathered whole
TP_ACTIONS_EQUAL = 0.999  # share of a 1 x 2 rank's rollout actions equal to the one-rank rollout's (the two ranks': all)
TP_MAIN = DP2 + ["--mesh_model=2", "--experiment=tp"]  # `main` in float32, the default --tp_min_layer_width=512
# the GRU's leaves (3H = 768) are the only ones 512 wide: the convs (16, 32 channels) and the Dense 256 stay whole
TP_MAIN_SHARDED = {f"core.gru_0.{leaf}": dim for leaf, dim in (("wi", 1), ("wh", 1), ("bi", 0), ("bh", 0))}
# leg (b): `__graft_entry__.py:9-31, 84-95`, the JAX package's multichip dry run: SyntheticDiscreteEnv(6 actions,
# episodes of 32, 36x36), convnet_atari + Dense 512, GRU-512 float32, rollout 16, 4 envs a data shard, batch
# num_envs * 16 / 2, one epoch, --tp_min_layer_width=256; one iteration (smoke depth) on 2 x 2 and on 4 x 1
TP_MULTICHIP_ENV = "tp_multichip_synthetic"
TP_MULTICHIP = ["--env=" + TP_MULTICHIP_ENV, "--use_rnn=True", "--rnn_size=512", "--encoder_conv_architecture=convnet_atari",
                "--encoder_conv_mlp_layers", "512", "--rollout=16", "--recurrence=16", "--batch_size=64", "--num_envs=8",
                "--num_epochs=1", "--tp_min_layer_width=256", "--async_rl=False", "--compute_dtype=float32",
                "--train_for_env_steps=128", "--seed=0", "--device=gpu", "--jax_distributed=True", *QUIET]


def register_tp_multichip_env():
    from sample_factory_tpu_torch.envs.builtin.synthetic import SyntheticDiscreteEnv
    from sample_factory_tpu_torch.envs.env_utils import register_env

    register_env(TP_MULTICHIP_ENV, lambda name, cfg=None, env_config=None, render_mode=None: SyntheticDiscreteEnv(
        num_actions=6, episode_len=32, res=36))


class CollectiveTraffic:
    """The torch.distributed collectives of this process, by label: calls, bytes (an all-gather's
    whole output, an all-reduce's buffer) and the host's ms inside them (gloo waits for the card's
    stream, copies, exchanges and copies back inside the call)."""

    def __init__(self, dist):
        self.dist, self.label, self.by_label, self.saved = dist, None, {}, {}

    def __enter__(self):
        for name in ("all_gather", "all_reduce", "broadcast"):
            self.saved[name] = getattr(self.dist, name)
            setattr(self.dist, name, self._counting(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)

    def _counting(self, name, fn):
        def counted(tensor_or_list, *args, **kwargs):
            start = time.perf_counter()
            out = fn(tensor_or_list, *args, **kwargs)
            if self.label is not None:
                row = self.by_label.setdefault(self.label, {})
                entry = row.setdefault(name, {"calls": 0, "bytes": 0, "host_ms": 0.0})
                tensors = tensor_or_list if isinstance(tensor_or_list, list) else [tensor_or_list]
                entry["calls"] += 1
                entry["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
                entry["host_ms"] += (time.perf_counter() - start) * 1e3
            return out

        return counted


def probe_collectives(torch, device="cuda"):
    """Each collective the tensor-parallel path uses, on cuda:0 tensors over gloo, held against its
    exact value before anything relies on it: all_gather of float32 slices (a layer's gather and its
    shards' gather for a checkpoint), all_reduce (a column-parallel input's gradient, the norms), both
    in a group made by new_group, and the object broadcast of replicate_tree."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    group = dist.new_group(list(range(world)))
    x = torch.arange(6, dtype=torch.float32, device=device).reshape(3, 2) + 100 * rank
    out = {}
    for name, g in (("world", None), ("new_group", group)):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=g)
        out[f"all_gather_{name}"] = all(bool(torch.equal(p, x - 100 * rank + 100 * r)) and p.device == x.device for r, p in enumerate(parts))
        y = x.clone()
        dist.all_reduce(y, group=g)
        out[f"all_reduce_{name}"] = bool(torch.equal(y, world * (x - 100 * rank) + 100 * world * (world - 1) / 2)) and y.device == x.device
    box = [{"rank": rank}]
    dist.broadcast_object_list(box, src=0)
    out["broadcast_object_list"] = box[0] == {"rank": 0}
    check(all(out.values()), f"a collective failed on cuda:0 over gloo: {out}")
    return out


def tp_gloo_rank(torch, cuda_rnn, train_dir, traj_path):
    """Leg (a): one of the two ranks of a 1 x 2 mesh on cuda:0, `main` in float32: its rollout (the
    model group steps all 1024 envs), then the train call on the one-rank trajectory, then one more
    iteration under the profiler. Imports nothing of JAX."""
    import torch.distributed as dist

    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.parallel import multihost
    from sample_factory_tpu_torch.runner.checkpoint import full_state_dict
    from sample_factory_tpu_torch.train import make_rl_runner

    multihost.init_distributed(backend="gloo")
    probe = probe_collectives(torch)
    _, runner = make_rl_runner(parse_custom_args(TP_MAIN + [f"--train_dir={train_dir}", "--device=gpu", "--seed=0", "--jax_distributed=True"]))
    runner.init()
    shard, ts, mesh = runner.sampler_state.shard, runner.train_state, runner.mesh
    check(runner.device == torch.device("cuda", 0) and (shard.start, shard.stop) == (0, 1024), f"rank on {runner.device}, envs {shard}")
    check(ts.tp is not None and ts.tp.dims == TP_MAIN_SHARDED, f"sharded leaves {None if ts.tp is None else ts.tp.dims}")
    local = dict(ts.model.named_parameters())
    for name, dim in TP_MAIN_SHARDED.items():
        check(local[name].shape[dim] == 768 // 2, f"{name}: a shard of {tuple(local[name].shape)}")
    whole = torch.load(traj_path, map_location=runner.device)
    with CollectiveTraffic(dist) as traffic:
        torch.cuda.synchronize()
        traffic.label = "rollout"  # the runner's own: the shards gathered into the whole behaviour model, then the rollout
        model = runner._update_behavior_model()
        _, own, _ = runner._rollout_fn(model, ts.obs_rms, runner.sampler_state, ts.train_step, runner.policy_id)
        torch.cuda.synchronize()
        cuda_rnn.reset_launch_counts()
        traffic.label = "train"
        with launch_shapes(cuda_rnn) as shapes:
            stats = runner._train_fn(ts, whole, runner.train_generator)
            torch.cuda.synchronize()
        counts, train_step = cuda_rnn.launch_counts(), ts.train_step
        traffic.label = None
    full = full_state_dict(ts)
    params_path = os.path.join(train_dir, f"tp_rank{mesh.rank}.pt")
    torch.save({"params": {k: v.cpu() for k, v in full["model"].items()}, "actions": own["actions"].cpu(),
                "local": {k: v.detach().cpu() for k, v in ts.model.state_dict().items()}}, params_path)
    adam = ts.optimizer.state_dict()["state"]
    names = [name for name, _ in ts.model.named_parameters()]
    moments_halved = all(adam[i]["exp_avg"].shape == local[n].shape for i, n in enumerate(names) if n in TP_MAIN_SHARDED)

    def iteration():
        runner._train_iteration()

    wall_us, device_us, rnn_us, on_device, _ = profiled_device_time(iteration)
    return {"rank": mesh.rank, "model_index": mesh.model_index, "probe": probe, "launches": counts, "params": params_path,
            "launch_shapes": sorted(set(shapes)),
            "rollout_actions_equal_share": float((own["actions"] == whole["actions"]).float().mean()),
            "stats": {k: float(stats[k]) for k in DP_STATS}, "train_step": train_step, "moments_halved": moments_halved,
            "collectives": traffic.by_label,
            "profiled_iteration": {"device_busy_ms": device_us / 1e3, "rnn_kernel_ms": rnn_us / 1e3, "wall_ms": wall_us / 1e3,
                                   "device_activities": len(on_device)}}


def tp_multichip_rank(torch, cuda_rnn, train_dir):
    """Leg (b): one of four gloo ranks on cuda:0: the JAX package's multichip configuration for one
    iteration on a 2 x 2 mesh, then on 4 x 1. Imports nothing of JAX."""
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.parallel import multihost
    from sample_factory_tpu_torch.runner.checkpoint import full_state_dict
    from sample_factory_tpu_torch.runner.runner import AlgoObserver
    from sample_factory_tpu_torch.train import make_rl_runner

    multihost.init_distributed(backend="gloo")
    register_tp_multichip_env()
    out = {"rank": multihost.process_index()}
    for name, mesh_model in (("tp", 2), ("dp", 1)):
        losses = []

        class Losses(AlgoObserver):
            def on_training_iteration(self, runner, stats):
                losses.append(float(stats["loss"]))

        _, runner = make_rl_runner(parse_custom_args(TP_MULTICHIP + [f"--mesh_model={mesh_model}", f"--train_dir={train_dir}",
                                                                     f"--experiment=multichip_{name}"]))
        runner.register_observer(Losses())
        runner.init()
        torch.cuda.synchronize()
        cuda_rnn.reset_launch_counts()
        with launch_shapes(cuda_rnn) as shapes:
            check(runner.run() == 0, f"{name}: runner.run() failed")
            torch.cuda.synchronize()
        counts = cuda_rnn.launch_counts()
        ts = runner.train_state
        path = os.path.join(train_dir, f"multichip_{name}_rank{out['rank']}.pt")
        torch.save({k: v.cpu() for k, v in full_state_dict(ts)["model"].items()}, path)
        out[name] = {"losses": losses, "launches": counts, "launch_shapes": sorted(set(shapes)), "params": path, "env_steps": runner.env_steps,
                     "sharded": sorted(ts.tp.dims) if ts.tp is not None else [],
                     "mesh": [runner.mesh.data_index, runner.mesh.model_index], "episodes": runner.episode_stats.total_episodes}
    return out


def spawn_ranks(mode, args, env, out_paths):
    """A gloo rank a path of `out_paths` on cuda:0 (LOCAL_RANK=0 in all), each `chip_smoke.py --dp-child mode out_path *args`."""
    port, world = free_port(), len(out_paths)
    procs = []
    for rank, out_path in enumerate(out_paths):
        rank_env = dict(env, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        cmd = [sys.executable, os.path.abspath(__file__), "--dp-child", mode, out_path, *args]
        procs.append(subprocess.Popen(cmd, env=rank_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def collect_ranks(procs, out_paths, timeout=300):
    results = []
    try:
        for proc, out_path in zip(procs, out_paths):
            stdout, stderr = proc.communicate(timeout=timeout)
            check(proc.returncode == 0, f"a gloo rank failed ({proc.returncode}):\n{stdout[-2000:]}\n{stderr[-4000:]}")
            with open(out_path) as f:
                results.append(json.load(f))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def phase_tp(torch, cuda_rnn, card, tmp):
    """Tensor parallelism (`parallel/tensor_parallel.py`). (a) `main` in float32 on a 1 x 2 mesh of gloo
    ranks on cuda:0 against one rank of 1024 envs: the probe of the collectives, the rollout's actions,
    the parameters after one sync train call of 2 shuffled minibatches within TP_TOL, `gru_seq` on the
    gathered `wh` once a minibatch on each rank, the collectives an iteration, and the device busy ms
    of a profiled iteration beside the one rank's. (b) the JAX package's multichip configuration on a
    2 x 2 mesh of four gloo ranks against 4 x 1: the grid design (`gru_seq_grid`) on the gathered GRU-512, a
    cooperative launch of 128 blocks on each of the four ranks sharing the card."""
    script = os.path.abspath(__file__)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(script) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("WORLD_SIZE", None)
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.train import make_rl_runner

    start = time.perf_counter()
    one_dir = os.path.join(tmp, "tp_one")
    _, one = make_rl_runner(parse_custom_args(DP2 + [f"--train_dir={one_dir}", "--device=gpu", "--seed=0"]))
    one.init()
    ts = one.train_state
    _, traj, _ = one._rollout_fn(ts.model, ts.obs_rms, one.sampler_state, ts.train_step, one.policy_id)
    traj_path = os.path.join(tmp, "tp_trajectory.pt")
    torch.save(traj, traj_path)
    out_paths = [os.path.join(tmp, f"tp_rank{r}.json") for r in range(2)]
    procs = spawn_ranks("tp_gloo", [os.path.join(tmp, "tp"), traj_path], env, out_paths)
    full_precision(torch)
    one_stats = one._train_fn(ts, traj, one.train_generator)  # meanwhile, the reference train call
    one_stats = {k: float(one_stats[k]) for k in DP_STATS}
    want = {k: v.detach().cpu().clone() for k, v in ts.model.state_dict().items()}  # before the profiled iteration trains on
    ranks = collect_ranks(procs, out_paths)
    wall_us, device_us, rnn_us, _, _ = profiled_device_time(one._train_iteration)
    got = [torch.load(r["params"]) for r in ranks]
    diff = max(float((g["params"][k] - v).abs().max()) for g in got for k, v in want.items())
    replicas_diff = {k: float((got[0]["local"][k] - got[1]["local"][k]).abs().max()) for k in want if k not in TP_MAIN_SHARDED}
    replicated_equal = not any(replicas_diff.values())
    shards_differ = all(not torch.equal(got[0]["local"][k], got[1]["local"][k]) for k in TP_MAIN_SHARDED)
    stats_err = {k: max(abs(r["stats"][k] - v) / max(1.0, abs(v)) for r in ranks) for k, v in one_stats.items()}
    shares = [r["rollout_actions_equal_share"] for r in ranks]
    check(torch.equal(got[0]["actions"], got[1]["actions"]), "the 1 x 2 ranks' rollouts acted differently: their envs would part")
    check(min(shares) >= TP_ACTIONS_EQUAL, f"the 1 x 2 ranks' rollout actions equal one rank's at {shares} < {TP_ACTIONS_EQUAL}")
    rollout_calls = [{k: v["calls"] for k, v in r["collectives"]["rollout"].items()} for r in ranks]
    check(rollout_calls == [{"all_gather": 1}] * 2, f"a rollout's collectives: {rollout_calls}, not the one gather of the shards")
    check(diff <= TP_TOL, f"1 x 2 against one rank: max |param diff| {diff} > {TP_TOL}")
    check(max(stats_err.values()) <= DP_STATS_TOL, f"1 x 2 ranks' train stats against one rank's: {stats_err} > {DP_STATS_TOL}")
    check(replicated_equal and shards_differ, f"the model group's replicated leaves differ ({replicas_diff}), or its shards are equal")
    check(all(r["moments_halved"] for r in ranks), "an Adam moment of a sharded leaf is not its shard's shape")
    check(all(r["launches"]["gru_seq"] == 2 and r["launches"]["gru_seq_rows"] == 0 for r in ranks),
          f"a rank did not launch the GRU kernel (cluster design) once a minibatch: {[r['launches'] for r in ranks]}")
    for k, r in enumerate(ranks):
        check_backward_launches(r["launches"], f"tp (a) rank {k}")
    check(all(r["launch_shapes"] == [["gru", 32, 512, 256]] for r in ranks), f"launch shapes {[r['launch_shapes'] for r in ranks]}")
    check(all(r["train_step"] == 2 for r in ranks), "train steps differ")
    emit({"phase": "tp", "leg": "main_float32_1x2_gloo_on_cuda0",
          "config": "main (grid_battle, convnet_impala + Dense 256, GRU-256) in float32, 1024 envs, rollout 32, 1 sync train call of 2 "
                    "shuffled minibatches of 16384, --tp_min_layer_width=512: the GRU's wi, wh, bi, bh sharded",
          "probe": ranks[0]["probe"], "max_abs_param_diff": diff, "tol": TP_TOL, "stats_rel_err": stats_err,
          "rollout_actions_equal_share": shares, "ranks_actions_equal": True, "gru_seq_by_rank": [r["launches"]["gru_seq"] for r in ranks],
          "collectives_by_rank": [r["collectives"] for r in ranks],
          "profiled_iteration_by_rank": [r["profiled_iteration"] for r in ranks],
          "profiled_iteration_one_rank": {"device_busy_ms": device_us / 1e3, "rnn_kernel_ms": rnn_us / 1e3, "wall_ms": wall_us / 1e3},
          "seconds": time.perf_counter() - start, "card": card})
    del one

    start_b = time.perf_counter()
    out_paths = [os.path.join(tmp, f"tp_multichip_rank{r}.json") for r in range(4)]
    procs = spawn_ranks("tp_multichip", [os.path.join(tmp, "tp_multichip")], env, out_paths)
    ranks_b = collect_ranks(procs, out_paths)
    params = {name: [torch.load(r[name]["params"]) for r in ranks_b] for name in ("tp", "dp")}
    diff_b = max(float((g[k] - v).abs().max()) for g in params["tp"] for k, v in params["dp"][0].items())
    losses = {name: ranks_b[0][name]["losses"] for name in ("tp", "dp")}
    check([r["tp"]["mesh"] for r in ranks_b] == [[0, 0], [0, 1], [1, 0], [1, 1]], "the 2 x 2 layout")
    check(all("core.gru_0.wh" in r["tp"]["sharded"] for r in ranks_b), f"wh not sharded: {ranks_b[0]['tp']['sharded']}")
    check(all(len(r[name]["losses"]) == 1 and math.isfinite(r[name]["losses"][0]) for r in ranks_b for name in ("tp", "dp")), "losses")
    check(math.isclose(losses["tp"][0], losses["dp"][0], rel_tol=2e-3, abs_tol=2e-4), f"2 x 2 loss against 4 x 1: {losses}")
    check(diff_b <= 1e-5, f"2 x 2 against 4 x 1: max |param diff| {diff_b} > 1e-5")
    # two contiguous minibatches of 64 rows: the first is data index 0's rows, the second data index 1's, and a
    # rank launches the recurrence only on a minibatch it holds rows of
    check(all(r["tp"]["launches"]["gru_seq_grid"] == 1 and forward_launches(r["tp"]["launches"]) == 1 for r in ranks_b),
          f"a 2 x 2 rank did not launch the GRU's grid design on its minibatch: {[r['tp']['launches'] for r in ranks_b]}")
    for k, r in enumerate(ranks_b):
        check_backward_launches(r["tp"]["launches"], f"tp (b) rank {k}")
    check(all(r["tp"]["launch_shapes"] == [["gru", *TP_MULTICHIP_GRU[:3]]] for r in ranks_b),
          f"2 x 2 launch shapes {[r['tp']['launch_shapes'] for r in ranks_b]}, not {TP_MULTICHIP_GRU[:3]}")
    check(all(r["tp"]["episodes"] == r["dp"]["episodes"] for r in ranks_b), "episode counts differ between the meshes")
    emit({"phase": "tp", "leg": "jax_multichip_config_2x2_against_4x1",
          "config": "__graft_entry__.py's dry run: convnet_atari + Dense 512, GRU-512 float32, 8 envs, rollout 16, batch 64, "
                    "--tp_min_layer_width=256, one iteration",
          "sharded": ranks_b[0]["tp"]["sharded"], "losses": losses, "max_abs_param_diff": diff_b, "tol": 1e-5,
          "gru_seq_grid_by_rank": [r["tp"]["launches"]["gru_seq_grid"] for r in ranks_b],
          "seconds": time.perf_counter() - start_b, "card": card})
    counts = [r["launches"] for r in ranks] + [r["tp"]["launches"] for r in ranks_b]
    return {k: sum(c[k] for c in counts) for k in counts[0]}


# phase `dp_host`: (a) `host_rnn` in float32 with the quantized learner, two gloo ranks of 256 envs on cuda:0
# against one rank of 512: 16,384 rows a train step in 2 shuffled minibatches of 8,192, 2 epochs, 2 iterations
DP_HOST_ENVS = 256  # a rank's: 1 worker x 256 envs
DP_HOST_ITERS = 2
DP_HOST_STATS = DP_STATS + ("epochs_executed",)
DP_HOST = [a for a in HOST_PIXEL if not a.startswith(("--num_workers=", "--num_envs_per_worker=", "--batch_size=", "--num_epochs="))] + [
    "--num_workers=1", f"--num_envs_per_worker={DP_HOST_ENVS}", "--use_rnn=True", "--rnn_size=256", "--recurrence=32",
    "--compute_dtype=float32", "--batch_size=8192", "--shuffle_minibatches=True", "--num_epochs=2",
    f"--train_for_env_steps={DP_HOST_ITERS * 2 * DP_HOST_ENVS * 32}", "--experiment=dp_host"]
DP_HOST_GRU_PER_RANK = DP_HOST_ITERS * 2 * 2  # train steps x epochs x minibatches: one launch a minibatch


def dp_host_gloo_rank(torch, cuda_rnn, train_dir):
    """One of two gloo ranks on cuda:0 in `DP_HOST`, through make_rl_runner -> init -> run: its first
    trajectory, the parameters and stats of the first flushed train step, its launches, its saves."""
    import sample_factory_tpu_torch.runner.runner as runner_module
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.parallel import multihost
    from sample_factory_tpu_torch.train import make_rl_runner

    multihost.init_distributed(backend="gloo")
    rank = multihost.process_index()
    argv = DP_HOST + [f"--train_dir={train_dir}", "--device=gpu", "--seed=0", "--jax_distributed=True"]
    _, runner = make_rl_runner(parse_custom_args(argv), register_fn=register_bench_pixel)
    runner.init()
    q = runner._quantizer
    check(type(runner).__name__ == "HostEnvRunner" and runner.device == torch.device("cuda", 0) and q is not None,
          f"rank {rank}: {type(runner).__name__} on {runner.device}, quantizer {q}")
    check(runner.sampler.num_envs == DP_HOST_ENVS and q.num_minibatches == 2 and q.sgd_steps_per_train == 4,
          f"rank {rank}: {runner.sampler.num_envs} envs, {q.num_minibatches} minibatches, {q.sgd_steps_per_train} sgd steps a train step")
    first = {}
    enqueue, flush = q.enqueue, q.flush

    def first_enqueue(ts, traj, generator):
        if "traj" not in first:
            first["traj"] = os.path.join(train_dir, f"traj_rank{rank}.pt")
            torch.save(traj, first["traj"])
        return enqueue(ts, traj, generator)

    def first_flush():
        stats = flush()
        if "stats" not in first:
            first["stats"] = {k: float(v) for k, v in stats.items()}
            first["params"] = os.path.join(train_dir, f"first_params_rank{rank}.pt")
            torch.save({k: v.cpu() for k, v in runner.train_state.model.state_dict().items()}, first["params"])
        return stats

    q.enqueue, q.flush = first_enqueue, first_flush
    saves, save_checkpoint = [], runner_module.save_checkpoint

    def counting_save(*args, **kwargs):
        saves.append(args[3])  # env_steps
        return save_checkpoint(*args, **kwargs)

    runner_module.save_checkpoint = counting_save
    torch.cuda.synchronize()
    cuda_rnn.reset_launch_counts()
    check(runner.run() == 0, f"rank {rank}: runner.run() failed")
    torch.cuda.synchronize()
    counts = cuda_rnn.launch_counts()
    multihost.sync_barrier()  # rank 0's final checkpoint is on disk
    final = os.path.join(train_dir, f"final_params_rank{rank}.pt")
    torch.save({k: v.cpu() for k, v in runner.train_state.model.state_dict().items()}, final)
    ckpts = sorted(f for f in os.listdir(os.path.join(train_dir, "dp_host", "checkpoint_p0")) if f.startswith("checkpoint_"))
    return {"rank": rank, "launches": counts, "saves": saves, "checkpoints": ckpts, "env_steps": runner.env_steps,
            "env_seed_offset": runner.cfg.env_seed_offset, "final_params": final, "train_step": runner.train_state.train_step, **first}


def dp_host_rate_run(torch, cuda_rnn, mode, train_dir, experiment, profile):
    """`host` (feed-forward, async, 2 workers x 1024 envs) for 3 iterations through make_rl_runner (with
    --jax_distributed=True when `mode` is `nccl`); with `profile`, a 4th iteration under the profiler for the
    NCCL kernels' device time. The all-reduce calls, the host's time inside them and in the runner's
    `_process_stats` (where the episode sums and the stop go up) are read at the end of each iteration."""
    import torch.distributed as dist

    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.runner.runner import AlgoObserver

    iters = 4 if profile else 3
    argv = HOST_PIXEL + ["--use_rnn=False", f"--train_for_env_steps={iters * HOST_ENVS * 32}", f"--experiment={experiment}"]
    calls, all_reduce, host_s = [], dist.all_reduce, {"all_reduce": 0.0, "process_stats": 0.0}

    def counting_all_reduce(*args, **kwargs):
        calls.append(1)
        t0 = time.perf_counter()
        try:
            return all_reduce(*args, **kwargs)
        finally:
            host_s["all_reduce"] += time.perf_counter() - t0

    class Marks(AlgoObserver):
        """The all-reduce calls made and the host seconds spent by the end of each iteration; stops the
        profiler after the last."""

        def __init__(self):
            self.at_end, self.host_s_at_end, self.prof, self.wall_s = [], [], None, None

        def on_training_iteration(self, runner, stats):
            self.at_end.append(len(calls))
            self.host_s_at_end.append(dict(host_s))
            if self.prof is not None and self.wall_s is None:
                torch.cuda.synchronize()
                self.wall_s = time.perf_counter() - self.t0
                self.prof.stop()

    marks = Marks()

    def before_run(runner):
        train_iteration, process_stats = runner._train_iteration, runner._process_stats

        def timed_process_stats(*args):
            t0 = time.perf_counter()
            process_stats(*args)
            host_s["process_stats"] += time.perf_counter() - t0

        runner._process_stats = timed_process_stats

        def profiled_last():
            if profile and len(marks.at_end) == iters - 1:
                torch.cuda.synchronize()
                marks.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                marks.prof.start()
                marks.t0 = time.perf_counter()
            return train_iteration()

        runner._train_iteration = profiled_last

    dist.all_reduce = counting_all_reduce
    try:
        runner, counts, stats, times = train(torch, cuda_rnn, argv + (["--jax_distributed=True"] if mode == "nccl" else []), train_dir,
                                             before_run, observers=[marks], register_fn=register_bench_pixel, device_flag=())
    finally:
        dist.all_reduce = all_reduce
    per_iter = [b - a for a, b in zip(times, times[1:])]
    check(len(per_iter) == iters, f"{mode}: expected {iters} iterations, ran {len(per_iter)}")
    check(type(runner).__name__ == "HostEnvRunner" and runner._quantizer is not None, f"{mode}: {type(runner).__name__}")
    check(runner.mesh.distributed == (mode == "nccl") and runner.mesh.world == 1, f"{mode}: mesh {runner.mesh}")
    check(calls if mode == "nccl" else not calls, f"{mode}: {len(calls)} all-reduces")
    if mode == "nccl":
        check(dist.get_backend() == "nccl" and runner.device == torch.device("cuda", 0), f"backend {dist.get_backend()}, device {runner.device}")
    out = {"mode": mode, "iteration_s": per_iter, "env_steps_per_s_steady": HOST_ENVS * 32 * 2 / sum(per_iter[1:3]),
           "launches": counts, "loss": stats["loss"], "all_reduce_calls_by_iteration_end": marks.at_end,
           "all_reduce_calls_an_iteration": marks.at_end[2] - marks.at_end[1], "all_reduce_calls_run": len(calls),
           "host_ms_in_iteration_3": {k: 1e3 * (marks.host_s_at_end[2][k] - marks.host_s_at_end[1][k]) for k in host_s}}
    if marks.prof is not None:
        device_us, _, on_device, _ = device_activities(marks.prof)
        nccl = [e for e in on_device if "nccl" in e.name.lower()]
        out["profiled_iteration"] = {"device_busy_ms": device_us / 1e3, "wall_ms": marks.wall_s * 1e3, "nccl_kernels": len(nccl),
                                     "nccl_ms": sum(e.time_range.elapsed_us() for e in nccl) / 1e3,
                                     "nccl_names": sorted({e.name[:60] for e in nccl})}
    return out


def phase_dp_host(torch, cuda_rnn, card, tmp):
    """The host runners under a process group (`runner/host_runner.py`). (a) two gloo ranks on cuda:0, each
    with its own sampler over 256 `bench_host_pixel` envs, GRU-256 float32 and the quantized learner, against
    one rank handed their first trajectories joined on the env axis in rank order: the parameters of the first
    flushed train step within DP_TOL, its stats within DP_STATS_TOL, the replicas equal after both iterations,
    the envs seeded RANK_SEED_STRIDE apart and the first rollout's actions drawn apart, `gru_seq` once a
    minibatch on each rank, one checkpoint. (b) `host` in a world of 1 over NCCL under torch.distributed.run, in turns with the same run
    without a group (DP_HOST_TURNS: DP_TURNS after an uncounted warm-up run): env steps/s, the all-reduces an
    iteration, one profiled iteration's NCCL kernels and device time."""
    from sample_factory_tpu_torch.algo.learning import init_train_state
    from sample_factory_tpu_torch.algo.quantized_train import QuantizedTrainer
    from sample_factory_tpu_torch.cfg.arguments import verify_cfg
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.envs.env_info import obtain_env_info
    from sample_factory_tpu_torch.examples.train_synthetic import parse_custom_args
    from sample_factory_tpu_torch.models.actor_critic import create_actor_critic

    script = os.path.abspath(__file__)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(script) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("WORLD_SIZE", None)
    start = time.perf_counter()
    port, rank_dir, procs = free_port(), os.path.join(tmp, "dp_host"), []
    for rank in (0, 1):
        rank_env = dict(env, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        out_path = os.path.join(tmp, f"dp_host_rank{rank}.json")
        cmd = [sys.executable, script, "--dp-child", "host_gloo", out_path, rank_dir]
        procs.append((subprocess.Popen(cmd, env=rank_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out_path))
    # meanwhile, the one-rank reference's initial state, rebuilt from the seed as the runner builds it
    cfg = parse_custom_args(DP_HOST + [f"--train_dir={os.path.join(tmp, 'dp_host_one')}", "--device=gpu", "--seed=0"])
    verify_cfg(cfg)
    env_info = obtain_env_info(cfg, register_fn=register_bench_pixel)
    device = torch.device("cuda", 0)
    model = create_actor_critic(cfg, env_info.obs_space, env_info.action_space, torch.Generator().manual_seed(cfg.seed)).to(device)
    ts = init_train_state(cfg, env_info, model, device)
    ranks = []
    for proc, out_path in procs:
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
        check(proc.returncode == 0, f"a gloo rank of dp_host failed ({proc.returncode}):\n{stdout[-2000:]}\n{stderr[-4000:]}")
        with open(out_path) as f:
            ranks.append(json.load(f))
    trajs = [torch.load(r["traj"], map_location=device) for r in ranks]

    def join(parts):
        return {k: join([p[k] for p in parts]) if isinstance(v, dict) else torch.cat([p[k] for p in parts], dim=1) for k, v in parts[0].items()}

    joined = join(trajs)
    q = QuantizedTrainer(cfg, env_info, 0, num_envs=2 * DP_HOST_ENVS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q.enqueue(ts, joined, torch.Generator(device).manual_seed(cfg.seed + 2))
    while q.dispatch_one():
        pass
    one_stats = {k: float(v) for k, v in q.flush().items()}
    torch.cuda.synchronize()
    reference_s = time.perf_counter() - t0
    want = {k: v.cpu() for k, v in ts.model.state_dict().items()}
    got = [torch.load(r["params"]) for r in ranks]
    diff = max(float((g[k] - v).abs().max()) for g in got for k, v in want.items())
    finals = [torch.load(r["final_params"]) for r in ranks]
    identical = all(bool(torch.equal(finals[0][k], finals[1][k])) for k in finals[0])
    stats_err = {k: max(abs(r["stats"][k] - one_stats[k]) / max(1.0, abs(one_stats[k])) for r in ranks) for k in DP_HOST_STATS}
    # bench_host_pixel's frames ignore the env seed (as bench.py:434-474's do): the ranks see equal frames, so
    # their actions differ through their own draws alone (ROADMAP C, P1)
    obs_equal = bool(torch.equal(trajs[0]["obs"]["obs"], trajs[1]["obs"]["obs"]))
    actions_equal_share = float((trajs[0]["actions"] == trajs[1]["actions"]).float().mean())
    steps = DP_HOST_ITERS * 2 * DP_HOST_ENVS * 32
    check(q.num_minibatches == 2 and joined["rewards"].shape[1] == 2 * DP_HOST_ENVS, f"reference: {q.num_minibatches} minibatches")
    check([r["env_seed_offset"] for r in ranks] == [0, 1000003], f"env seed offsets {[r['env_seed_offset'] for r in ranks]}")
    check(actions_equal_share < 0.5, f"the ranks drew the same actions on {actions_equal_share} of the first rollout's steps")
    check(max(stats_err.values()) <= DP_STATS_TOL, f"two ranks' first train step against one rank's: {stats_err} > {DP_STATS_TOL}")
    check(diff <= DP_TOL, f"two ranks against one rank after the first train step: max |param diff| {diff} > {DP_TOL}")
    check(identical, "the two ranks' replicas differ after the run")
    check(all(r["launches"]["gru_seq"] == DP_HOST_GRU_PER_RANK and forward_launches(r["launches"]) == DP_HOST_GRU_PER_RANK for r in ranks),
          f"a rank did not launch gru_seq once a minibatch ({DP_HOST_GRU_PER_RANK}): {[r['launches'] for r in ranks]}")
    for k, r in enumerate(ranks):
        check_backward_launches(r["launches"], f"dp_host rank {k}")
    check(ranks[0]["saves"] == [steps] and ranks[1]["saves"] == [] and all(r["checkpoints"] == [f"checkpoint_{2 * 4:012d}_{steps}.pth"] for r in ranks),
          f"saves {[r['saves'] for r in ranks]}, checkpoints {[r['checkpoints'] for r in ranks]}: rank 0 alone writes one")
    check(all(r["env_steps"] == steps and r["train_step"] == 2 * 4 for r in ranks), "env steps or train steps differ")
    emit({"phase": "dp_host", "leg": "gloo_two_ranks_on_cuda0",
          "config": "host_rnn in float32 (bench_host_pixel 42x42x4, convnet_simple + MLP 128, GRU-256, recurrence 32), async quantized, "
                    "1 worker x 256 envs a rank, 2 shuffled minibatches of 8192, 2 epochs, 2 iterations",
          "max_abs_param_diff": diff, "tol": DP_TOL, "stats_rel_err": stats_err, "stats_tol": DP_STATS_TOL, "stats_one_rank": one_stats,
          "replicas_identical": identical, "first_rollout_frames_equal": obs_equal, "first_rollout_actions_equal_share": actions_equal_share,
          "gru_seq_by_rank": [r["launches"]["gru_seq"] for r in ranks], "saves_by_rank": [r["saves"] for r in ranks],
          "reference_train_step_s": reference_s, "seconds": time.perf_counter() - start, "card": card})
    del ts, q, joined, trajs

    start_b = time.perf_counter()
    out_path = os.path.join(tmp, "dp_host_turns.json")
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1"]
    runs = run_child(launch + [script, "--dp-child", "host_turns", out_path, os.path.join(tmp, "dp_host_turns")], env, out_path)
    check([r["mode"] for r in runs] == list(DP_HOST_TURNS), f"runs {[r['mode'] for r in runs]}")
    rate = {mode: [r["env_steps_per_s_steady"] for r in runs if r["mode"] == mode] for mode in ("nccl", "nogroup")}
    emit({"phase": "dp_host", "leg": "nccl_world_of_1", "config": "host (bench_host_pixel, 2 workers x 1024 envs, rollout 32, batch 8192, async quantized)",
          "turns": [r["mode"] for r in runs], "env_steps_per_s_steady_iterations_2_3": rate,
          "warmup_env_steps_per_s_iterations_2_3": runs[0]["env_steps_per_s_steady"],
          "ratio_group_over_no_group": statistics.mean(rate["nccl"]) / statistics.mean(rate["nogroup"]),
          "all_reduce_calls_an_iteration": {f"{k}_{r['mode']}": r["all_reduce_calls_an_iteration"] for k, r in enumerate(runs)},
          "all_reduce_calls_by_iteration_end": {f"{k}_{r['mode']}": r["all_reduce_calls_by_iteration_end"] for k, r in enumerate(runs)},
          "host_ms_in_iteration_3": {f"{k}_{r['mode']}": r["host_ms_in_iteration_3"] for k, r in enumerate(runs)},
          "profiled_iteration_of_the_last_group_run": runs[-1]["profiled_iteration"],
          "iteration_s": {f"{k}_{r['mode']}": r["iteration_s"] for k, r in enumerate(runs)}, "seconds": time.perf_counter() - start_b,
          "phase_s": time.perf_counter() - start, "card": card})
    counts = [r["launches"] for r in ranks] + [r["launches"] for r in runs if r["mode"] == "nccl"]
    return {k: sum(c[k] for c in counts) for k in counts[0]}


BENCH_METRICS = ["mlp_synthetic_sync_ppo_framework_ceiling", "host_pixel_pipeline_appo", "host_pipeline_slab_producer_rate",
                 "host_pipeline_device_put_split", "host_pipeline_inference_only", "multihost_scaling_proxy_2proc",
                 "host_pixel_pipeline_appo_gpu", "grid_battle_pixel_rnn_ppo", "ant_physics_sync_ppo"]


def phase_bench(torch, card):
    """`bench_gpu.py --smoke` in a child process: every row with a value naming the card, none an error, no
    impossible MFU, the two flop counters in agreement, and the headline with the suite last."""
    here = os.path.dirname(os.path.abspath(__file__))
    start = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.join(here, "bench_gpu.py"), "--smoke"], cwd=here, capture_output=True,
                         text=True, timeout=600)
    seconds = time.perf_counter() - start
    check(out.returncode == 0, f"bench_gpu.py --smoke exited {out.returncode}:\n{out.stdout[-3000:]}\n{out.stderr[-4000:]}")
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    check([r["metric"] for r in rows] == BENCH_METRICS, f"bench rows {[r['metric'] for r in rows]}")
    name = torch.cuda.get_device_name(0)
    for r in rows:
        check("error" not in r and r.get("value") is not None and r.get("device") == name and r.get("power_limit_w"),
              f"bench row {r}")
        check(not r.get("mfu_violation") and r.get("mfu", 0.0) < 1.0, f"{r['metric']}: impossible MFU {r.get('mfu')}")
        check(0.9 <= r.get("flops_xcheck_ratio", 1.0) <= 1.5, f"{r['metric']}: flop counters disagree, {r.get('flops_xcheck_ratio')}")
    check(rows[-1]["suite"][:-1] == rows[:-1] and rows[-1]["suite"][-1]["metric"] == rows[-1]["metric"], "the headline's suite")
    emit({"phase": "bench", "seconds": seconds,
          "rows": [{k: v for k, v in r.items() if k not in ("suite", "note")} for r in rows], "card": card})


def kernels_line(paths, main_err, timing, bwd_timing):
    """The `kernels` line: each kernel's launches by path (`paths`: each path's launch counts) and its numbers from phases
    `parity` (`main_err`), `timing` and `bwd`."""
    # launches: each path was driven with the counts at 0 just before it and read just after, and
    # each kernel's are counted by design (cluster: `*_seq`; grid: `*_seq_grid`; rows: `*_seq_rows`);
    # `gru_seq` and `lstm_seq` count every design of their port, `*_seq_grid` the grid design alone. A
    # kernel's numbers are its cluster design's at the main-path shape, the row design's and the grid
    # design's at the doom (GRU) or nethack (LSTM) path's shape, and the grid design's at each of its sites
    def by_design(name, counts):
        return {"cluster": counts[name], "grid": counts[f"{name}_grid"], "rows": counts[f"{name}_rows"],
                "resident": counts.get(f"{name}_resident", 0), "resident_in": counts.get(f"{name}_resident_in", 0)}

    # the resident design's sites: launches where a path runs the kernel there (the instruction encoder's, `dmlab`)
    dmlab_sites = {"dmlab_instruction_rollout": "instruction_rollout", "dmlab_instruction_last_value": "instruction_learner_last_value",
                   "dmlab_instruction_learner": "instruction_learner"}

    def resident_launches(site, backward=False, kernel="lstm_seq_resident"):
        launched = SITE_LAUNCHES.get("dmlab", {}).get(dmlab_sites.get(site), {"kernel": None, "launches": 0})
        if launched["kernel"] != kernel:
            return 0
        return launched["launches"] if not backward or site == "dmlab_instruction_learner" else 0

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": sum(sum(by_design(name, counts).values()) for counts in paths.values()),
         "launches_by_design": {d: sum(by_design(name, counts)[d] for counts in paths.values()) for d in by_design(name, paths["main"])},
         "paths": {path: by_design(name, counts) for path, counts in paths.items()},
         "max_abs_err": main_err[name], **timing[name], "library_ms": None,
         "row_design": {"max_abs_err": main_err[f"{name}_rows"], **timing[f"{name}_rows"], "library_ms": None}}
        for name in ("gru_seq", "lstm_seq")
    ] + [
        {"name": f"{kind}_seq_grid", "route": "cuda", "source": SOURCE, "replaces": REPLACES[f"{kind}_seq"],
         "launches": sum(counts[f"{kind}_seq_grid"] for counts in paths.values()),
         "paths": {path: counts[f"{kind}_seq_grid"] for path, counts in paths.items()},
         "max_abs_err": main_err[f"{kind}_seq_grid"], **timing[f"{kind}_seq_grid"], "library_ms": None,
         "sites": {site: {"launches": paths[path][f"{kind}_seq_grid"], "max_abs_err": main_err[f"{kind}_seq_grid@{site}"],
                          **timing[f"{kind}_seq_grid@{site}"], "library_ms": None}
                   for site, (site_kind, _, path) in GRID_SITES.items() if site_kind == kind}}
        for kind in ("gru", "lstm")
    ] + [
        # the backward kernels, each design (the cluster design, `*_seq_cluster_bwd`, at the bf16 and H <= 256 sites; the
        # grid design, `*_seq_grid_bwd`, at the float32 H=512 ones; the row design, `*_seq_bwd`, where the forward takes the
        # row design: GRU-1024 and LSTM-1024 in bf16, which no path runs; the resident design, `lstm_seq_resident_bwd`, at DMLab's
        # instruction encoder over a minibatch): their
        # numbers at the first learner site of their kind and design (BWD_LINE_SITES), then at each learner site it runs;
        # ms is the kernel's, whole_backward_ms the prologue, kernel and epilogue's, plain_ms the plain recurrence's,
        # remat_ms the remat's (the plain forward rerun under autograd); at a grid or cluster site rows_ms is the row
        # design's kernel at the same shape, timed in turns
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": sum(counts[name] for counts in paths.values()),
         "paths": {path: counts[name] for path, counts in paths.items()},
         "max_abs_err": main_err[name][0], "grad_rel_err": main_err[name][1], **bwd_timing[first], "library_ms": None,
         "sites": {site: {"launches": paths[path][name] if path else 0, "max_abs_err": main_err[f"{name}@{site}"][0],
                          "grad_rel_err": main_err[f"{name}@{site}"][1], **bwd_timing[site], "library_ms": None}
                   for site, (kind, _, path) in BWD_SITES.items() if f"{name}@{site}" in main_err}}
        for name, first in BWD_LINE_SITES.items()
    ] + [
        # the resident design (the LSTM at H <= 64 where a cluster plan needs several waves): its numbers at DMLab's learner
        # instruction encoder, then at each RESIDENT_SITE (launches where a path runs it there), beside the row design in
        # turns, the cluster plan where there is one, and cuDNN's LSTM (library_ms: forward; cudnn: both routes, in turns)
        {"name": "lstm_seq_resident", "route": "cuda", "source": SOURCE, "replaces": REPLACES["lstm_seq_resident"],
         "launches": sum(counts["lstm_seq_resident"] for counts in paths.values()),
         "paths": {path: counts["lstm_seq_resident"] for path, counts in paths.items()},
         "max_abs_err": main_err["lstm_seq_resident"], **timing["lstm_seq_resident"],
         "sites": {site: {"launches": resident_launches(site), "max_abs_err": main_err[f"lstm_seq_resident@{site}"],
                          **timing[f"lstm_seq_resident@{site}"]} for site in RESIDENT_SITES}},
    ]
    # the resident backward: cuDNN's backward as its library call where the site is float32, and the resident sites no learner
    # runs (timed in phase `bwd` beside the row design)
    resident_bwd = next(k for k in kernels if k["name"] == "lstm_seq_resident_bwd")
    resident_bwd["library_ms"] = timing["lstm_seq_resident"]["cudnn"]["cudnn_bwd_ms"]
    resident_bwd["cudnn"] = timing["lstm_seq_resident"]["cudnn"]
    resident_bwd["sites"]["dmlab_instruction_learner"]["library_ms"] = resident_bwd["library_ms"]
    resident_bwd["sites"].update({
        site: {"launches": resident_launches(site, backward=True), "max_abs_err": main_err[f"lstm_seq_resident_bwd@{site}"][0],
               "grad_rel_err": main_err[f"lstm_seq_resident_bwd@{site}"][1], **bwd_timing[f"resident@{site}"],
               "library_ms": timing[f"lstm_seq_resident@{site}"]["cudnn"].get("cudnn_bwd_ms")}
        for site in RESIDENT_SITES if site not in BWD_SITES})
    # lstm_seq_in's kernels, the route of DMLab's instruction encoder: the forward with the input product folded in, its numbers
    # at the learner's site (where it also writes the backward's buffers) and at each RESIDENT_SITE, beside the unfused route (the
    # Linear + `lstm_seq_resident`) in turns; the backward on the saved buffers, beside the resident backward that recomputes the
    # cell states; library_ms: cuDNN's LSTM forward, and its whole backward (cudnn: the three routes in turns, forward and
    # backward)
    kernels += [
        {"name": "lstm_seq_resident_in", "route": "cuda", "source": SOURCE, "replaces": REPLACES["lstm_seq_resident_in"],
         "launches": sum(counts["lstm_seq_resident_in"] for counts in paths.values()),
         "paths": {path: counts["lstm_seq_resident_in"] for path, counts in paths.items()},
         "max_abs_err": main_err["lstm_seq_resident_in"], "lstm_seq_in_grad_rel_err": main_err["lstm_seq_in_grad"],
         **timing["lstm_seq_resident_in"],
         "sites": {site: {"launches": resident_launches(site, kernel="lstm_seq_resident_in"),
                          "max_abs_err": main_err[f"lstm_seq_resident_in@{site}"], **timing[f"lstm_seq_resident_in@{site}"]}
                   for site in RESIDENT_SITES}},
        {"name": "lstm_seq_resident_in_bwd", "route": "cuda", "source": SOURCE, "replaces": REPLACES["lstm_seq_resident_in_bwd"],
         "launches": sum(counts["lstm_seq_resident_in_bwd"] for counts in paths.values()),
         "paths": {path: counts["lstm_seq_resident_in_bwd"] for path, counts in paths.items()},
         "max_abs_err": main_err["lstm_seq_resident_in_bwd"][0], "grad_rel_err": main_err["lstm_seq_resident_in_bwd"][1],
         **bwd_timing["resident_in@dmlab_instruction_learner"],
         "library_ms": timing["lstm_seq_resident_in"]["cudnn"]["cudnn_bwd_ms"], "cudnn": timing["lstm_seq_resident_in"]["cudnn"],
         "sites": {site: {"launches": resident_launches(site, backward=True, kernel="lstm_seq_resident_in"),
                          "max_abs_err": main_err[f"lstm_seq_resident_in_bwd@{site}"][0],
                          "grad_rel_err": main_err[f"lstm_seq_resident_in_bwd@{site}"][1], **bwd_timing[f"resident_in@{site}"],
                          "library_ms": timing[f"lstm_seq_resident_in@{site}"]["cudnn"].get("cudnn_bwd_ms")}
                   for site in RESIDENT_SITES}},
    ]
    return kernels


def main() -> int:
    # the isaacgym phase's stand-in refuses a process that has imported torch, as NVIDIA's isaacgym
    # does: it is imported first, as a user's script imports it
    with standins_on_path():
        import isaacgym  # noqa: F401
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from sample_factory_tpu_torch.envs.batched_host_env import register_bench_pixel
    from sample_factory_tpu_torch.examples.train_synthetic import register_synthetic_components
    from sample_factory_tpu_torch.native import shm_queue
    from sample_factory_tpu_torch.ops import cuda_rnn

    register_synthetic_components()
    register_bench_pixel()
    full_precision(torch)  # for the comparisons
    card = card_line()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card})

    global SPEC
    start = time.perf_counter()
    queue_path = shm_queue.build()  # g++; raises where it fails, so that the pipe transport cannot hide it
    lib_path = cuda_rnn.build()
    cuda_rnn.load_library()
    log = lib_path.with_suffix(".log").read_text() if lib_path.with_suffix(".log").exists() else ""
    SPEC = cuda_rnn.card_spec(0)
    # on the H100 SXM's SM count every path keeps the plan it had when the planner read module constants
    # (cuda_rnn.H100_SXM); the paths: the parity phase's, the cluster sites, the host and population GRUs
    path_shapes = ([(kind, (T, B, H, dtype)) for kind, T, B, H, dtype, _, _ in PARITY_PATH_SHAPES] + list(CLUSTER_SITES.values())
                   + [("gru", HOST_GRU), ("gru", (32, 16, 512, "float32"))])
    if SPEC.sms == cuda_rnn.H100_SXM.sms:
        for kind, (T, B, H, dtype) in path_shapes:
            plan, sxm = cuda_rnn.launch_plan(kind, T, B, H, dtype, SPEC), cuda_rnn.launch_plan(kind, T, B, H, dtype, cuda_rnn.H100_SXM)
            check(plan == sxm, f"{kind} {(T, B, H, dtype)}: {plan} on this card ({SPEC}), {sxm} on the H100 SXM")
    # the launch plan counts on the clusters that the card runs at once (SPEC): its waves, and the row
    # design in place of a cluster plan of several waves at a small width (the DMLab learner's encoder)
    at_once = {}
    for name, (kind, (T, B, H, dtype)) in CLUSTER_SITES.items():
        plan = cuda_rnn.cluster_plan(kind, B, H, dtype, SPEC)
        check(plan is not None, f"{name}: {(T, B, H, dtype)} has no cluster plan")
        at_once[name] = {"shape": [T, B, H], "dtype": dtype, "clusters": plan.grid // plan.cluster, "waves": cuda_rnn.cluster_waves(plan, SPEC),
                         "planned": cuda_rnn.launch_plan(kind, T, B, H, dtype, SPEC).design,
                         "card_runs_at_once": cuda_rnn.max_active_clusters(kind, dtype, plan)}
        check(at_once[name]["card_runs_at_once"] >= max(1, SPEC.clusters_at_once(plan.cluster)), f"{name}: no cluster of {plan} fits the card")
    # the grid design's cooperative launches need every block resident at once (one a SM: SPEC.sms at most)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid_at_once = {}
    for site, (kind, (T, B, H, dtype), _) in GRID_SITES.items():
        plan = cuda_rnn.launch_plan(kind, T, B, H, dtype, SPEC)
        check(plan.design == "grid", f"{site}: {(T, B, H, dtype)} does not take the grid design")
        grid_at_once[site] = {"kernel": kind, "shape": [T, B, H], "dtype": dtype, "blocks": plan.grid, "threads": plan.threads,
                              "smem": plan.smem, "blocks_per_sm": cuda_rnn.grid_blocks_per_sm(kind, plan), "sms": sms}
        check(plan.grid <= SPEC.sms and plan.grid <= grid_at_once[site]["blocks_per_sm"] * sms, f"{site}: {plan} is not resident at once")
        # the backward takes the grid design at the same sites, all resident too
        bwd = cuda_rnn.bwd_plan(kind, B, H, dtype, SPEC)
        check(bwd.design == "grid", f"{site}: {(T, B, H, dtype)}'s backward does not take the grid design: {bwd}")
        grid_at_once[site]["backward"] = {"blocks": bwd.grid, "threads": bwd.threads, "smem": bwd.smem,
                                          "blocks_per_sm": cuda_rnn.grid_bwd_blocks_per_sm(kind, bwd)}
        check(bwd.grid <= SPEC.sms and bwd.grid <= grid_at_once[site]["backward"]["blocks_per_sm"] * sms, f"{site}: {bwd} is not resident at once")
    # the backward takes the forward's design at every learner site; a cluster backward plan's clusters run on the card, as
    # many at once as the spec counts for its size
    bwd_clusters = {}
    for site, (kind, (T, B, H, dtype), _) in BWD_SITES.items():
        bwd, fwd = cuda_rnn.bwd_plan(kind, B, H, dtype, SPEC), cuda_rnn.launch_plan(kind, T, B, H, dtype, SPEC)
        check(bwd.design == fwd.design, f"{site}: the backward takes {bwd}, the forward {fwd}")
        if bwd.design == "cluster":
            bwd_clusters[site] = {"kind": kind, "shape": [T, B, H], "dtype": dtype, "plan": dataclasses.asdict(bwd),
                                  "clusters": bwd.grid // bwd.cluster, "waves": cuda_rnn.cluster_waves(bwd, SPEC),
                                  "card_runs_at_once": cuda_rnn.max_active_bwd_clusters(kind, dtype, bwd)}
            check(bwd_clusters[site]["card_runs_at_once"] >= max(1, SPEC.clusters_at_once(bwd.cluster)), f"{site}: no cluster of {bwd} fits")
    emit({"phase": "build", "seconds": time.perf_counter() - start, "library": lib_path.name, "shm_queue_library": queue_path.name,
          "card_spec": dataclasses.asdict(SPEC), "paths_keep_the_h100_sxm_plans": SPEC.sms == cuda_rnn.H100_SXM.sms,
          "ptxas": [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line],
          "clusters_at_main_shapes": at_once, "grid_at_path_shapes": grid_at_once, "backward_clusters_at_sites": bwd_clusters})

    main_err = phase_parity(torch, cuda_rnn)
    timing = phase_timing(torch, cuda_rnn, card)
    bwd_timing = phase_bwd(torch, cuda_rnn, card)
    phase_plans(torch, cuda_rnn, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        paths = {}
        runner, paths["main"], sync_rate = phase_main(torch, cuda_rnn, card, tmp)
        phase_breakdown(torch, runner, card)
        paths["lstm"] = phase_lstm(torch, cuda_rnn, card, tmp)
        paths["appo"] = phase_appo(torch, cuda_rnn, card, tmp, runner, sync_rate)
        del runner
        paths["defaults"] = phase_defaults(torch, cuda_rnn, card, tmp)
        paths["dp"], paths["dp2"] = phase_dp(torch, cuda_rnn, card, tmp)
        paths["tp"] = phase_tp(torch, cuda_rnn, card, tmp)
        paths["ant"] = phase_ant(torch, cuda_rnn, card, tmp)
        paths["towers"] = phase_towers(torch, cuda_rnn, card, tmp)
        paths["population"] = phase_population(torch, cuda_rnn, card, tmp)
        paths["selfplay"] = phase_selfplay(torch, cuda_rnn, card, tmp)
        phase_enjoy(torch, card, tmp)
        phase_export(torch, card, tmp)
        paths["host"] = phase_host(torch, cuda_rnn, card, tmp)
        paths["host_rnn"] = phase_host_rnn(torch, cuda_rnn, card, tmp)
        paths["dp_host"] = phase_dp_host(torch, cuda_rnn, card, tmp)
        paths["host_selfplay"] = phase_host_selfplay(torch, cuda_rnn, card, tmp)
        phase_host_enjoy(torch, card, tmp)
        paths["custom_model"] = phase_custom_model(torch, cuda_rnn, card, tmp)
        paths["atari"] = phase_atari(torch, cuda_rnn, card, tmp)
        paths["doom"] = phase_doom(torch, cuda_rnn, card, tmp)
        paths["dmlab"] = phase_dmlab(torch, cuda_rnn, card, tmp)
        paths["nethack"] = phase_nethack(torch, cuda_rnn, card, tmp)
        paths["isaacgym"] = phase_isaacgym(torch, cuda_rnn, card, tmp)
        phase_bench(torch, card)
        cuda_rnn.reset_launch_counts()
        phase_sampler(torch, card, tmp)
        check(all(v == 0 for v in cuda_rnn.launch_counts().values()), "an RNN kernel launched in the sampler phase")

    emit({"kernels": kernels_line(paths, main_err, timing, bwd_timing)})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-child"]:
        sys.exit(dp_child(*sys.argv[2:]))
    sys.exit(main())
