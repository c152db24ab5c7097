"""Twenty train steps of a small mnist_digit 'ours' model in the port
(training/step.py) against ladder_tpu's jitted step, from identical weights,
batches, GM and noise, as tests/test_torch_train_step.py does for CelebA:
the train state enters the port through the bridge (the encoder's
flattened Dense_0 rows and their moments permuted), JAX's sampler is a
queue baked into the compiled step, and the port is handed the same draws
at every step.

Tolerances (test_torch_train_step.py's, for the same reasons): metrics
taken before any update rtol 1e-4, later ones 5e-3. Parameters after
twenty steps: Adam moves an element by about lr per step whatever the
gradient's size, and a gradient of rounding size may take either sign in
either package, so 98% of a group's elements agree within 0.1 lr per step
taken, their mean within a tenth of that, and every element within 2 lr
per step."""

import jax
import jax.numpy as jnp
import numpy as np

import ladder_tpu.training.step as jstep
from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu_torch.models.builder import LadderModel
from ladder_tpu_torch.training import step as tstep
from tests.conftest import make_config
from tests.test_torch_losses import (
    NoiseQueue,
    few_threads,  # noqa: F401  (autouse fixture: two torch threads)
    gm_for,
    jax_gm,
    noise_for,
    torch_gm,
    torch_noise,
)
from tests.test_torch_train_step import LATER_METRIC_TOL, LRS, METRIC_TOL

B, STEPS = 8, 20


def leaves(tree):
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


def test_twenty_steps_match_jax(monkeypatch):
    cfg = make_config(batch_size=B)
    jmodel = jmake(cfg)
    # the port's seeded weights stand in for flax's initialiser (cheaper
    # here than JAX's eager init); both packages start from them
    params = jax.tree.map(jnp.asarray, LadderModel(cfg, seed=2).flax_params())
    jmodel.init = lambda rng: params
    jstate = jstep.init_state(jmodel, jax.random.PRNGKey(0))
    state = tstep.init_state(LadderModel(cfg, seed=9),
                             flax_state=jax.tree.map(np.asarray, jstate),
                             device="cpu")
    jfn = jstep.make_train_step(jmodel, jit=True)
    tfn = tstep.make_train_step(state["model"])
    rng = np.random.default_rng(0)
    gm = gm_for(cfg)
    draws = [noise_for(cfg, rng, batch=B)
             for _ in range(len(tstep.group_keys(cfg)))]
    queue = NoiseQueue(monkeypatch)
    queue.feed(draws)
    flags = {"use_sg_prior": False, "use_mask": False}
    for i in range(STEPS):
        x = rng.random((B, 28, 28, 1)).astype(np.float32)
        jstate, jout = jfn(jstate, jnp.asarray(x), jax.random.PRNGKey(0),
                           jax_gm(gm),
                           {k: jnp.asarray(v) for k, v in flags.items()},
                           LRS, do_prior=True)
        state, out = tfn(state, x, None, torch_gm(gm), flags, LRS, True,
                         noise=[torch_noise(d) for d in draws])
        assert set(out) == set(jout) == {"ae", "sigma", "prior"}
        for group in jout:
            for key, want in jout[group].items():
                np.testing.assert_allclose(
                    out[group][key].numpy(), np.asarray(want),
                    err_msg=f"step {i} {group}/{key}",
                    **(METRIC_TOL if i == 0 and group == "ae"
                       else LATER_METRIC_TOL))
    assert state["step"] == int(jstate["step"]) == STEPS
    got = tstep.flax_state(state)
    want = jax.tree.map(np.asarray, jstate)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for name, keys in tstep.group_keys(cfg).items():
        assert int(got["opt"][name]["t"]) == STEPS
        lr = LRS[name]
        err = np.concatenate([
            np.abs(g - w).ravel() for k in keys
            for g, w in zip(leaves(got["params"][k]),
                            leaves(want["params"][k]))])
        assert err.max() <= 2 * lr * STEPS, (name, err.max() / lr)
        assert (err <= 0.1 * lr * STEPS).mean() >= 0.98, name
        assert err.mean() <= 0.01 * lr * STEPS, (name, err.mean() / lr)
