"""The slice as a whole: the port's train step (ladder_tpu_torch/training/
step.py) against ladder_tpu's on a small CelebA 'ours' model, from identical
weights, optimiser state, batch, GM and noise. The train state crosses
through the bridge both ways. ladder_tpu's step is jitted: its sampler runs
while the step is traced, so the queue's draws become constants of the
compiled step, and every step uses the same noise (fresh for each sub-step);
the port is handed the same draws at every step. This is also the test that holds autograd
through the port's explicit [2x resize -> 3x3 conv] against ladder_tpu's
lhs-dilated form with its hand-written VJP.

Tolerances. Float32 on both sides, the same ops in other summation orders.
Metrics taken before any update: rtol 1e-4; after one: rtol 5e-3, because
Adam's first steps move a parameter by lr * sign(g) and the sign of a
gradient of rounding size differs between the packages (the bounds of
chip_smoke.py's card-against-CPU check, for the same reason). Gradients: 1e-5 of the group's largest gradient element
(an untrained model's loss is ~5e4 and its gradients are large; their
rounding noise scales with them). Parameters after three steps: 98% of a
group's elements within 0.1 lr, their mean error within 0.01 lr and every
element within 2 lr a step (the sign effect again: half a percent of the
decoder's kernel elements drift by up to 1.6 lr in three sequential steps).
Moments: that noise, 1e-5 of a largest gradient of ~1e4, is 0.1 beside
clipped gradients of at most 1 and enters m with weight 0.1 a step, so 98%
of a group's moment elements are held to 3e-2, their mean error to 3e-3,
and every element to the clip's bound of 1.
EXCEPT the parameters whose true gradient is zero: the biases of convolutions that feed
a batch or instance norm, and the centre tap of the decoder's Conv_1, whose
input is constant over its 2x2 map. Their computed gradient is rounding
noise, of another sign in each package, and Adam turns a sign into a step of
lr: they are held to 2 lr per step.

The train-state bridge itself (utils/weights.py:flax_state_to_torch and
back, step.py:init_state / flax_state) is tested at the end: a flax train
state crosses into the port and back bit for bit, and the moments of a
kernel take the layout changes of the kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.tree_util import keystr, tree_flatten_with_path

import ladder_tpu.training.losses as jlosses
import ladder_tpu.training.step as jstep
from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu_torch.models.builder import LadderModel
from ladder_tpu_torch.training import step as tstep
from ladder_tpu_torch.training.losses import compute_loss
from ladder_tpu_torch.utils.weights import (
    flax_state_to_torch,
    flax_to_torch,
    torch_state_to_flax,
    torch_to_flax,
)
from tests.test_torch_losses import (
    B,
    NoiseQueue,
    few_threads,  # noqa: F401  (autouse fixture: two torch threads)
    gm_for,
    jax_gm,
    noise_for,
    small_celeba,
    torch_gm,
    torch_noise,
)

LRS = dict(ae=3e-4, sigma=5e-4, prior=3e-4, inner_sigma=2e-4)
METRIC_TOL = dict(rtol=1e-4, atol=1e-4)
LATER_METRIC_TOL = dict(rtol=5e-3, atol=1e-3)
NORM_FED = {"encoder": [f"Conv_{i}" for i in range(6)],
            "decoder": ["Conv_1", "Conv_2", "Conv_4", "Conv_6"]}


def zero_gradient_mask(path, leaf):
    """True where the parameter's true gradient is zero (module docstring)."""
    mask = np.zeros(np.shape(leaf), bool)
    for group, convs in NORM_FED.items():
        for conv in convs:
            if path == f"['{group}']['{conv}']['bias']":
                mask[...] = True
    if path == "['decoder']['Conv_1']['kernel']":
        mask[1, 1] = True
    return mask


def leaves(tree):
    return [(keystr(k), np.asarray(v))
            for k, v in tree_flatten_with_path(tree)[0]]


def both_states(cfg, seed=0):
    """(jax model, jax state, port state) with the same weights and zero
    moments, the port's loaded from the flax state through the bridge."""
    jmodel = jmake(cfg)
    jstate = jstep.init_state(jmodel, jax.random.PRNGKey(seed))
    state = tstep.init_state(LadderModel(cfg, seed=99),
                             flax_state=jax.tree.map(np.asarray, jstate),
                             device="cpu")
    return jmodel, jstate, state


def run_both(cfg, steps, monkeypatch, flags=None, **kw):
    """``steps`` train steps in both packages; returns the two final states
    as flax-layout numpy trees after comparing every step's metrics."""
    jmodel, jstate, state = both_states(cfg)
    jfn = jstep.make_train_step(jmodel, jit=True)
    tfn = tstep.make_train_step(state["model"])
    queue = NoiseQueue(monkeypatch)
    rng = np.random.default_rng(0)
    gm = gm_for(cfg)
    flags = flags or {}
    calls = len(tstep.group_keys(cfg)) if cfg["fused_train_step"] == 1 else 1
    draws = [noise_for(cfg, rng) for _ in range(calls)]
    # the single-pass mode's second backward reuses the first's noise
    queue.feed(draws * (2 if kw.get("sg_overlap") else 1))
    for i in range(steps):
        x = rng.random((B, 128, 128, 3)).astype(np.float32)
        jstate, jout = jfn(jstate, jnp.asarray(x), jax.random.PRNGKey(0),
                           jax_gm(gm),
                           {k: jnp.asarray(v) for k, v in flags.items()},
                           LRS, do_prior=True, **kw)
        assert not queue.queue  # eaten by the trace of the first call
        state, out = tfn(state, x, None, torch_gm(gm), flags, LRS, True,
                         noise=[torch_noise(d) for d in draws], **kw)
        assert set(out) == set(jout)
        for group in jout:
            assert set(out[group]) == set(jout[group])
            before_updates = i == 0 and (group == "ae"
                                         or cfg["fused_train_step"] == 2)
            for key, want in jout[group].items():
                np.testing.assert_allclose(
                    out[group][key].numpy(), np.asarray(want),
                    err_msg=f"step {i} {group}/{key}",
                    **(METRIC_TOL if before_updates else LATER_METRIC_TOL))
    assert state["step"] == int(jstate["step"]) == steps
    return jax.tree.map(np.asarray, jstate), tstep.flax_state(state)


def group_errors(got, want, cap):
    """|got - want| over a group's leaves as one vector, without the
    elements whose true gradient is zero; every element within ``cap``."""
    errs = []
    for (path, g), (_, w) in zip(leaves(got), leaves(want)):
        err = np.abs(g - w)
        assert (err <= cap).all(), (path, err.max())
        errs.append(err[~zero_gradient_mask(path, w)].ravel())
    return np.concatenate(errs)


def compare_states(got, want, cfg, steps):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for name, keys in tstep.group_keys(cfg).items():
        lr = LRS["prior" if name == "z_std" else name]
        assert int(got["opt"][name]["t"]) == int(want["opt"][name]["t"])
        checks = [({k: got["params"][k] for k in keys},
                   {k: want["params"][k] for k in keys}, 0.1 * lr,
                   2.0 * lr * steps)]
        checks += [(got["opt"][name][moment], want["opt"][name][moment],
                    3e-2, 1.0) for moment in ("m", "v")]
        for g_tree, w_tree, tight, cap in checks:
            err = group_errors(g_tree, w_tree, cap)
            assert (err <= tight).mean() >= 0.98, (name, (err > tight).mean())
            assert err.mean() <= tight / 10, (name, err.mean())


@pytest.mark.parametrize("mode", [1, 2])
def test_three_steps_match_jax(mode, monkeypatch):
    cfg = small_celeba("ours", fused_train_step=mode)
    want, got = run_both(cfg, 3, monkeypatch)
    compare_states(got, want, cfg, 3)
    assert {n: int(g["t"]) for n, g in got["opt"].items()} == dict(
        ae=3, sigma=3, prior=3, inner_sigma=3)


def test_group_gradients_match_jax(monkeypatch):
    """The gradient each of the five sub-steps differentiates, at the same
    parameter point."""
    cfg = small_celeba("ours", TRAIN_decoded_z_std=1)
    jmodel, jstate, state = both_states(cfg, seed=1)
    model = state["model"]
    rng = np.random.default_rng(1)
    x = rng.random((B, 128, 128, 3)).astype(np.float32)
    gm, draws = gm_for(cfg), noise_for(cfg, rng)
    queue = NoiseQueue(monkeypatch)
    select = {"ae": "loss_ae", "sigma": "loss_ae", "prior": "loss_prior",
              "inner_sigma": "loss_prior", "z_std": "decoded_z_std_loss"}
    _, metrics = compute_loss(
        model, torch.tensor(x).permute(0, 3, 1, 2).contiguous(),
        gm=torch_gm(gm), noise=torch_noise(draws))
    params = jstate["params"]
    for name, keys in tstep.group_keys(cfg).items():
        def scalar(sub, name=name):
            return jlosses.compute_loss(
                jmodel, {**params, **sub}, jnp.asarray(x),
                jax.random.PRNGKey(0), jax_gm(gm))[1][select[name]]

        queue.feed([draws])
        want = jax.jit(jax.grad(scalar))({k: params[k] for k in keys})
        mine = tstep.group_params(model, keys)
        grads = torch.autograd.grad(metrics[select[name]],
                                    list(mine.values()), retain_graph=True,
                                    allow_unused=True)
        got = torch_to_flax({k: torch.zeros_like(p) if g is None else g
                             for (k, p), g in zip(mine.items(), grads)})
        scale = max(np.abs(w).max() for _, w in leaves(want))
        assert scale > 0 or name == "sigma"  # sigma sits under its floor
        for (path, g), (_, w) in zip(leaves(got), leaves(want)):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5 * scale,
                                       err_msg=f"{name}{path}")


def test_single_pass_sg_overlap_matches_jax(monkeypatch):
    """The epoch where prior training starts while the standard-gaussian
    switch is still on: the prior groups take their own backward."""
    cfg = small_celeba("ours", fused_train_step=2)
    want, got = run_both(cfg, 1, monkeypatch, flags={"use_sg_prior": True},
                         sg_overlap=True)
    compare_states(got, want, cfg, 1)
    moved = np.abs(got["opt"]["prior"]["m"]["prior"]["inner_encoder"]["enc_0"][
        "kernel"])
    assert moved.max() > 0  # loss_ae alone carries no elbo_prior gradient


def test_fifth_group_in_the_sequential_mode(monkeypatch):
    cfg = small_celeba("ours", TRAIN_decoded_z_std=1)
    assert list(tstep.group_keys(cfg)) == ["ae", "sigma", "prior",
                                           "inner_sigma", "z_std"]
    want, got = run_both(cfg, 1, monkeypatch)
    compare_states(got, want, cfg, 1)
    assert int(got["opt"]["z_std"]["t"]) == 1
    moments = got["opt"]["z_std"]["m"]["prior"]["inner_decoder"]
    assert np.abs(moments["decoded_code_std"]["kernel"]).max() > 0
    # decoded_code takes no gradient from this loss: its moments stay zero
    assert not np.abs(moments["decoded_code"]["kernel"]).any()


def test_single_pass_refuses_decoded_z_std():
    cfg = small_celeba("ours", fused_train_step=2, TRAIN_decoded_z_std=1)
    with pytest.raises(ValueError, match="TRAIN_decoded_z_std"):
        tstep.make_train_step(LadderModel(cfg))


def test_constants_and_groups_match_jax():
    assert tstep._SCALAR_KEYS == jstep._SCALAR_KEYS
    for prior in ("standard_gaussian", "ours", "hierarchical", "GMM",
                  "vampPrior"):
        for z_std in (0, 1):
            cfg = small_celeba(prior, TRAIN_decoded_z_std=z_std)
            assert tstep.group_keys(cfg) == jstep.group_keys(cfg)


def _port_run(cfg, seed=3):
    state = tstep.init_state(LadderModel(cfg, seed=seed), device="cpu")
    rng = np.random.default_rng(seed)
    batches = rng.integers(0, 256, (2, B, 128, 128, 3), dtype=np.uint8)
    return state, batches, torch_gm(gm_for(cfg))


def test_multi_step_is_the_single_step_in_a_loop():
    cfg = small_celeba("ours", fused_train_step=2)
    state_a, batches, gm = _port_run(cfg)
    state_b, _, _ = _port_run(cfg)
    multi = tstep.make_train_multi_step(state_a["model"])
    single = tstep.make_train_step(state_b["model"])
    state_a, outs = multi(state_a, batches, torch.Generator().manual_seed(5),
                          gm, {}, LRS, True)
    g = torch.Generator().manual_seed(5)
    for k in range(2):
        state_b, out = single(state_b, batches[k], g, gm, {}, LRS, True)
        assert torch.equal(outs["ae"]["loss_ae"][k], out["ae"]["loss_ae"])
    assert outs["ae"]["std_dev_code"].shape == (2, cfg["code_size"])
    assert state_a["step"] == state_b["step"] == 2
    for a, b in zip(state_a["model"].parameters(),
                    state_b["model"].parameters()):
        assert torch.equal(a, b)


def test_eval_step_and_forward_fns():
    cfg = small_celeba("ours")
    state, batches, gm = _port_run(cfg)
    model = state["model"]
    before = [p.detach().clone() for p in model.parameters()]
    metrics = tstep.make_eval_step(model)(
        batches[0], torch.Generator().manual_seed(1), gm, {})
    assert set(metrics) == set(tstep._SCALAR_KEYS) - {"decoded_z_std_loss"}
    assert all(not v.requires_grad and torch.isfinite(v).all()
               for v in metrics.values())
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    fns = tstep.make_forward_fns(model)
    assert set(fns) == {"encode", "decode", "encode_sample", "inner_encode",
                        "inner_decode", "representation_sample"}
    mean, std = fns["encode"](batches[0])                 # uint8 in
    as_float = fns["encode"](batches[0].astype(np.float32) / 255.0)
    torch.testing.assert_close(mean, as_float[0], rtol=1e-5, atol=1e-5)
    assert fns["decode"](mean).shape == (B, 128, 128, 3)
    z = fns["encode_sample"](batches[0], torch.Generator().manual_seed(2))
    t = fns["representation_sample"](batches[0],
                                     torch.Generator().manual_seed(2))
    assert z.shape == (B, 8) and t.shape == (B, 3)
    assert fns["inner_decode"](fns["inner_encode"](z)[0]).shape == (B, 8)


def test_init_state_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstep.init_state(LadderModel(small_celeba("ours")))


def test_short_noise_list_is_refused():
    cfg = small_celeba("ours")
    state, batches, gm = _port_run(cfg)
    fn = tstep.make_train_step(state["model"])
    draws = torch_noise(noise_for(cfg, np.random.default_rng(0)))
    with pytest.raises(ValueError, match="shorter"):
        fn(state, batches[0], None, gm, {}, LRS, True, noise=[draws])


# ---- the train-state bridge ----

def random_state(cfg, seed=0):
    """A flax-layout train state whose every leaf is distinct noise."""
    state = jax.tree.map(np.asarray, jstep.init_state(
        jmake(cfg), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for i, group in enumerate(state["opt"].values()):
        for moment in ("m", "v"):
            group[moment] = jax.tree.map(
                lambda a: rng.standard_normal(a.shape).astype(np.float32),
                group[moment])
        group["t"] = np.asarray(3 + i, np.int32)
    state["step"] = np.asarray(17, np.int32)
    return state


@pytest.mark.parametrize("prior, z_std", [("ours", 0), ("ours", 1),
                                          ("vampPrior", 0), ("GMM", 0)])
def test_state_round_trip_is_exact(prior, z_std):
    cfg = small_celeba(prior, TRAIN_decoded_z_std=z_std)
    state = random_state(cfg)
    back = torch_state_to_flax(flax_state_to_torch(state))
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_state_round_trip_through_the_model_is_exact():
    """flax state -> the port's state on a model -> flax state."""
    cfg = small_celeba("ours", TRAIN_decoded_z_std=1)
    state = random_state(cfg, seed=1)
    mine = tstep.init_state(LadderModel(cfg, seed=5), flax_state=state,
                            device="cpu")
    assert mine["step"] == 17
    assert {k: g["t"] for k, g in mine["opt"].items()} == {
        k: int(g["t"]) for k, g in state["opt"].items()}
    assert sorted(g["t"] for g in mine["opt"].values()) == [3, 4, 5, 6, 7]
    back = tstep.flax_state(mine)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, b)


def test_moments_take_the_kernels_layout():
    cfg = small_celeba("ours")
    state = random_state(cfg, seed=2)
    got = flax_state_to_torch(state)
    m = state["opt"]["ae"]["m"]
    mine = got["opt"]["ae"]["m"]
    # conv: HWIO -> OIHW
    np.testing.assert_array_equal(
        mine["decoder.Conv_4.weight"],
        m["decoder"]["Conv_4"]["kernel"].transpose(3, 2, 0, 1))
    # dense: [in, out] -> [out, in]
    np.testing.assert_array_equal(mine["decoder.Dense_0.weight"],
                                  m["decoder"]["Dense_0"]["kernel"].T)
    # the flat heads: rows permuted NHWC -> NCHW exactly as the kernel's are
    np.testing.assert_array_equal(
        mine["encoder.code_mean.weight"],
        flax_to_torch({"encoder": m["encoder"]})["encoder.code_mean.weight"])
    head = m["encoder"]["code_mean"]["kernel"]           # [(h, w, c), out]
    c = head.shape[0] // 4
    np.testing.assert_array_equal(
        mine["encoder.code_mean.weight"][:, 1 * 4 + 2],  # c=1, (h,w)=(1,0)
        head[2 * c + 1])
    # each group holds its own parameters' moments and nothing else
    assert set(got["opt"]) == {"ae", "sigma", "prior", "inner_sigma"}
    assert all(k.startswith(("encoder.", "decoder.")) for k in mine)
    assert set(got["opt"]["sigma"]["m"]) == {"sigma.sigma"}
    assert got["opt"]["prior"]["t"] == 5 and got["step"] == 17


def test_loading_refuses_a_state_of_other_groups():
    cfg = small_celeba("ours")
    other = random_state(small_celeba("ours", TRAIN_decoded_z_std=1))
    with pytest.raises(Exception):
        tstep.init_state(LadderModel(cfg), flax_state=other, device="cpu")
    state = random_state(cfg)
    del state["opt"]["sigma"]
    with pytest.raises(ValueError, match="optimiser groups"):
        tstep.init_state(LadderModel(cfg), flax_state=state, device="cpu")


def test_zero_state_matches_jax_init():
    cfg = small_celeba("ours")
    mine = tstep.init_state(LadderModel(cfg), device="cpu")
    want = jstep.init_state(jmake(cfg), jax.random.PRNGKey(0))
    back = tstep.flax_state(mine)
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, want)
    assert all(not torch.count_nonzero(v)
               for g in mine["opt"].values() for v in g["m"].values())
