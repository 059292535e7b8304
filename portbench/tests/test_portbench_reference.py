"""The plain references against the port's CPU paths at small sizes, the
controls against the limits, and runs of the harness on the CPU (its look
for a card skipped) with a fault planted under the timed path: each must
come out not correct."""
import time

import pytest
import torch

from portbench import harness
from portbench.faults import FAULTS
from portbench.harness import REPO

FR_HOST = {"batch": 2, "frame_hw": [32, 48], "pool_batches": 2, "reference_block": 2}
FR_NATIVE = {"batch": 2, "frame_hw": [32, 48], "pool_batches": 2, "reference_block": 2}
NR_SMALL = {"batch": 2, "render_hw": 32, "sem_hw": 28, "pool_batches": 2, "reference_block": 2}
TRAIN_SMALL = {"batch": 2, "render_hw": 32, "sem_hw": 28, "pool_batches": 4}
SMALL = {"dists-256-b16": FR_HOST, "dists-1080-b8": FR_NATIVE,
         "nrv8-score-b16": NR_SMALL, "nrv8-train-b4": TRAIN_SMALL}


def run_cpu(cell, seed=12_345_678_901):
    return harness.run_cell(cell, seed, 0.2, False, time.perf_counter(), "cpu", SMALL[cell])[0]


@pytest.mark.parametrize("feed,size", [("uint8", (32, 32)), ("float32", None)])
def test_dists_reference_matches_the_port_in_fp32(feed, size):
    from nerf_qa_torch.config import DISTSConfig
    from nerf_qa_torch.core import dists
    from nerf_qa_torch.core.vgg import VGG16Pyramid
    from nerf_qa_torch.eval.video_scorer import FrameScorer

    spec, code = harness.config_files("dists")
    ref = harness.reference_module("dists")
    gen = torch.Generator().manual_seed(3)
    state = code.vgg_state(gen, "cpu")
    vgg = VGG16Pyramid()
    vgg.load_state_dict(state)
    cfg = DISTSConfig(compute_dtype="float32", stats_impl="eager")
    scorer = FrameScorer(vgg, dists.load_pretrained_weights(cfg), cfg, resize_to=size,
                         device="cpu")
    if feed == "uint8":
        d = torch.randint(0, 256, (3, 40, 56, 3), generator=gen, dtype=torch.uint8)
        r = torch.randint(0, 256, (3, 40, 56, 3), generator=gen, dtype=torch.uint8)
    else:  # host frames as the score CLI hands them over: numpy, in [0, 1]
        d = torch.rand((3, 32, 48, 3), generator=gen).numpy()
        r = torch.rand((3, 32, 48, 3), generator=gen).numpy()
    alpha, beta = ref.alpha_beta(str(REPO / spec["alpha_beta"]), "cpu")
    want = ref.score_frames(state, alpha, beta, torch.as_tensor(d), torch.as_tensor(r), size,
                            dtype=torch.float32)
    assert torch.allclose(scorer.score_batch(d, r), want, rtol=0, atol=2e-6)


def _nr(decoder_dtype):
    spec, code = harness.config_files("nr-v8")
    ref_mod = harness.reference_module("nr-v8")
    gen = torch.Generator().manual_seed(5)
    model, weights = code.build(spec, gen, "cpu", 32, 28, decoder_dtype, "eager")
    ref = ref_mod.Reference(weights, spec, str(REPO / spec["alpha_beta"]), "cpu")
    return spec, model, weights, ref, gen


def test_nr_reference_scores_match_the_port():
    spec, model, _, ref, gen = _nr("float32")
    r256 = torch.rand((2, 32, 32, 3), generator=gen)
    r224 = torch.rand((2, 28, 28, 3), generator=gen)
    with torch.no_grad():
        got = model(r256, r224)
    assert torch.allclose(got, ref.score(r256, r224), rtol=0, atol=1e-6)


def test_nr_reference_training_matches_the_port_in_fp32():
    from nerf_qa_torch.config import TrainConfig
    from nerf_qa_torch.train.nr_train import NRTrainer

    spec, model, weights, ref, gen = _nr("float32")
    train = harness.load_module(harness.HERE / "entries" / "nr_train.py")
    batches = [train.train_batch(gen, 2, 32, 28, 0.05, "cpu") for _ in range(2)]
    trainer = NRTrainer(model, TrainConfig(lr=1e-4, schedule="constant", seed=9),
                        steps_per_epoch=1, device="cpu")
    trainer.set_decoder(model.decoder)
    got = [float(trainer.train_step(*b)["combined"]) for b in batches]
    losses, _, change = ref.train(batches, torch.Generator().manual_seed(9),
                                  dtype=torch.float32)
    assert got == pytest.approx([x["combined"] for x in losses], rel=1e-5)
    for name, p in model.decoder.named_parameters():
        moved = float((p.detach() - weights["decoder"][name]).norm())
        assert moved == pytest.approx(change[name], rel=1e-3, abs=1e-9), name


def test_nr_reference_training_from_a_state_matches_the_port():
    from nerf_qa_torch.config import TrainConfig
    from nerf_qa_torch.train.nr_train import NRTrainer

    spec, model, weights, ref, gen = _nr("float32")
    train = harness.load_module(harness.HERE / "entries" / "nr_train.py")
    batches = [train.train_batch(gen, 2, 32, 28, 0.05, "cpu") for _ in range(3)]
    trainer = NRTrainer(model, TrainConfig(lr=1e-4, schedule="constant", seed=9),
                        steps_per_epoch=1, device="cpu")
    trainer.set_decoder(model.decoder)
    trainer.train_step(*batches[0])
    opt = trainer.optimizer
    params = dict(model.decoder.named_parameters())
    start = {"params": {k: p.detach().clone() for k, p in params.items()},
             "exp_avg": {k: opt.state[p]["exp_avg"].clone() for k, p in params.items()
                         if p in opt.state},
             "exp_avg_sq": {k: opt.state[p]["exp_avg_sq"].clone() for k, p in params.items()
                            if p in opt.state},
             "step": 1}
    state = trainer.generator.get_state()
    got = [float(trainer.train_step(*b)["combined"]) for b in batches[1:]]
    losses, _, change = ref.train(batches[1:], torch.Generator().set_state(state),
                                  dtype=torch.float32, start=start)
    assert got == pytest.approx([x["combined"] for x in losses], rel=1e-5)
    for name, p in params.items():
        moved = float((p.detach() - start["params"][name]).norm())
        assert moved == pytest.approx(change[name], rel=1e-3, abs=1e-9), name


@pytest.mark.parametrize("cell", ["dists-256-b16", "dists-1080-b8", "nrv8-score-b16"])
def test_sound_run_is_correct(cell):
    assert run_cpu(cell)["correct"]


# bf16 on the CPU at 32² rounds otherwise than the card at 256²: the first
# step's loss gap reads ~5e-5 here against at most 5.1e-6 there, so only
# these numbers meet the card's limits here
HELD_ON_CPU = ("grad_gap", "update_gap", "post_loss_gap", "post_grad_gap", "post_update_gap")


def test_sound_training_run_holds_its_gradient_and_update_limits():
    checks = run_cpu("nrv8-train-b4")["checks"]
    for name in HELD_ON_CPU:
        assert checks[name]["value"] <= checks[name]["limit"], name


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_fails_a_limit(cell):
    entry = harness.make_entry(cell, 777, "cpu", SMALL[cell])
    assert any(c["value"] > c["limit"] for c in entry.control())


@pytest.mark.parametrize("cell,fault", [
    ("dists-256-b16", "answer_altered_fr"), ("dists-1080-b8", "answer_altered_fr"),
    ("nrv8-score-b16", "answer_altered_nr"), ("nrv8-train-b4", "state_unchanged"),
    ("nrv8-train-b4", "half_batch"), ("nrv8-train-b4", "loss_altered"),
    ("nrv8-train-b4", "updates_dropped_after_setup"),
    ("nrv8-train-b4", "stale_inputs_after_setup")])
def test_planted_fault_is_not_correct(cell, fault):
    with FAULTS[fault]():
        result = run_cpu(cell)
    assert not result["correct"]
    if cell == "nrv8-train-b4":  # a number that the sound run holds here fails
        checks = result["checks"]
        assert any(checks[k]["value"] > checks[k]["limit"] for k in HELD_ON_CPU)
