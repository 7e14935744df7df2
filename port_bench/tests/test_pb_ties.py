"""The first gradient where a sample of the first minibatch sits at a PPO clip bound to rounding: the reference takes
such a sample's policy term both ways, and `grad_gap` judges the program by the choice nearest its own."""

import pytest
import torch

from port_bench import check
from port_bench.harness import run_cell
from port_bench.reference import learner as ref_learner
from port_bench.tests.tiny import tiny


def bare_learner(max_grad_norm):
    learner = object.__new__(ref_learner.Learner)
    learner.f = {"max_grad_norm": max_grad_norm}
    learner.adam = ref_learner.Adam({"a": torch.zeros(2)}, 0.9, 0.999, 1e-6)
    return learner


def test_tied_terms_taken_both_ways():
    learner = bare_learner(100.0)
    grads = {"a": torch.tensor([3.0, 4.0])}
    kept = {"a": torch.tensor([1.0, 0.0])}  # this side kept its term: the other choice takes it out
    clipped = {"a": torch.tensor([0.0, 2.0])}  # this side clipped it: the other choice puts it in
    learner._first_moment_norms(grads, [(kept, True), (clipped, False)])
    expected = [[3.0, 4.0], [2.0, 4.0], [3.0, 6.0], [2.0, 6.0]]
    got = [choice["a"] for choice in learner.first_moment_norms]
    assert got == pytest.approx([0.1 * float(torch.tensor(v).norm()) for v in expected], rel=1e-6)


def test_every_choice_is_clipped_by_its_own_norm():
    learner = bare_learner(1.0)
    learner._first_moment_norms({"a": torch.tensor([3.0, 4.0])}, [({"a": torch.tensor([30.0, 40.0])}, False)])
    assert [c["a"] for c in learner.first_moment_norms] == pytest.approx([0.1, 0.1], rel=1e-5)  # both clipped to 1


def test_grad_gap_takes_the_nearest_choice():
    leaves = {"a": torch.zeros(2), "b": torch.zeros(2)}
    rollout = {"values": torch.zeros(2, 2), "log_probs": torch.zeros(2, 2), "states": torch.ones(3, 2, 4)}
    prog = {"rollouts": [rollout], "losses": [1.0], "leaves": {"a": torch.ones(2), "b": torch.ones(2)},
            "first_moment": {"a": torch.tensor([0.3, 0.4]), "b": torch.tensor([0.0, 1.0])}}
    ref = {**prog, "lr_mismatches": 0, "first_moment": {"a": torch.tensor([0.6, 0.8]), "b": torch.tensor([0.0, 1.0])}}
    assert check.numbers(prog, ref, leaves)["grad_gap"] == pytest.approx(0.5)
    ref["first_moment_norms"] = [{"a": 1.0, "b": 1.0}, {"a": 0.5, "b": 1.0}]
    assert check.numbers(prog, ref, leaves)["grad_gap"] == pytest.approx(0.0, abs=1e-7)
    ref["first_moment_norms"] = [{"a": 1.0, "b": 1.0}, {"a": 0.5, "b": 0.5}]  # nearer in "a", farther in "b"
    assert check.numbers(prog, ref, leaves)["grad_gap"] == pytest.approx(0.5)


def test_a_run_with_every_sample_tied(monkeypatch):
    # every sample of the first minibatch counts as tied: the MAX_TIES nearest are taken both ways
    monkeypatch.setattr(ref_learner, "CLIP_TIE", 10.0)
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = run_cell("allegro_lstm512.ppo16k", 2147483901, 0.2, False, device="cpu",
                     overrides=tiny("allegro_lstm512.ppo16k"), readings=("float64",))
    finally:
        torch.set_num_threads(saved)
    assert r["correct"], r["compared"]
    assert r["_readings"]["program"]["details"]["grad_choices"] == 2 ** ref_learner.MAX_TIES
