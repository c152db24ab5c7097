"""Data parallelism of the port (ladder_tpu_torch/parallel/mesh.py through
the train step, the loss and the BatchNorm) against ladder_tpu's GSPMD
mesh, and the mesh module's rules.

One 2-rank gloo group on the CPU, started once for the module (two
processes that import no JAX), runs every multi-rank check; the two sides
exchange files under a temporary directory:

  * one train step of the port's 2 ranks against ladder_tpu's step on a
    2-device mesh (conftest's virtual CPU devices), from the same weights,
    batch, GM and fed noise (the global batch's draws; each rank keeps its
    rows), for a small mnist_digit 'ours' model and a small CelebA (h=16)
    model, in mode 1 and mode 2. The CelebA model's sigma starts below its
    mean pixel error, so the floor is active and the all-reduced L1 sum
    carries its gradient back through the output stage's backward; its
    prior is the standard gaussian (the encoder's global BatchNorm and the
    output stage are what the mesh changes there; the mnist cases run the
    prior groups, and a smaller graph keeps JAX's compile short). Bounds:
    ladder_tpu's own for mesh against one device (tests/test_parallel.py:
    83-88): the loss rtol 1e-5, the parameters rtol 5e-3 atol 1e-5, EXCEPT
    the elements whose true gradient is zero (the CelebA conv biases that
    feed a norm and the decoder Conv_1's centre tap: tests/
    test_torch_train_step.py:zero_gradient_mask; their computed gradient
    is rounding noise, near Adam's epsilon) and those whose gradient the
    two packages computed with opposite signs: Adam's first step turns a
    sign into lr, so these are held to 2 lr. Every flip must be a gradient
    at the level of float32 rounding (within ROUNDING of its optimiser
    group's largest element), and apart from the zero-gradient elements
    at most 0.1% of the group flips (measured: 5 elements of ~19,000).
    Both ranks end bitwise equal;
  * the global BatchNorm (float32: outputs and gradients within 1e-6) and
    the sigma floor's gradient with the floor active (a small mnist_digit
    model in float64, where the cross-rank term of the floor is far above
    rounding: every parameter's gradient within 1e-6 of its largest
    element): 2 ranks on halves against one process on the whole batch.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ladder_tpu.parallel.mesh as jmesh
import ladder_tpu.training.step as jstep
from ladder_tpu.models.builder import make_model as jmake
from ladder_tpu_torch.models.builder import LadderModel
from ladder_tpu_torch.models.layers import BatchNormTrain
from ladder_tpu_torch.parallel import mesh as tmesh
from ladder_tpu_torch.training import step as tstep
from ladder_tpu_torch.training.losses import compute_loss
from ladder_tpu_torch.utils.checkpoint import load_msgpack, save_msgpack
from tests.conftest import make_config
from tests.test_torch_losses import (
    NoiseQueue,
    few_threads,  # noqa: F401  (autouse fixture: two torch threads)
    gm_for,
    jax_gm,
    noise_for,
    small_celeba,
)
from tests.test_torch_train_step import LRS, zero_gradient_mask

ROOT = Path(__file__).resolve().parents[1]
B = 4          # global batch: 2 rows per rank
WORLD = 2


def _celeba(**kw):
    return dict(small_celeba("standard_gaussian", **kw), batch_size=B)


STEP_CASES = {
    "mnist_1": dict(cfg=lambda: make_config(batch_size=B,
                                            fused_train_step=1),
                    shape=(B, 28, 28, 1)),
    "mnist_2": dict(cfg=lambda: make_config(batch_size=B,
                                            fused_train_step=2),
                    shape=(B, 28, 28, 1)),
    "celeba_1": dict(cfg=lambda: _celeba(fused_train_step=1),
                     shape=(B, 128, 128, 3)),
    "celeba_2": dict(cfg=lambda: _celeba(fused_train_step=2),
                     shape=(B, 128, 128, 3)),
}
FLAGS = {"use_sg_prior": False, "use_mask": False}
SIGMA = 0.01   # below the untrained models' mean pixel error: the floor
# the port's and ladder_tpu's float32 gradients agree within 1e-5 of their
# group's largest element (tests/test_torch_train_step.py); ten times that
# is rounding level here
ROUNDING = 1e-4
BN_SHAPE = (B, 6, 4, 4)

WORKER = textwrap.dedent('''
    import json, os, sys
    import numpy as np, torch
    from ladder_tpu_torch.models.builder import LadderModel
    from ladder_tpu_torch.models.layers import (BatchNormTrain,
                                                set_batchnorm_mesh)
    from ladder_tpu_torch.parallel.mesh import make_mesh
    from ladder_tpu_torch.training import step as tstep
    from ladder_tpu_torch.training.losses import compute_loss
    from ladder_tpu_torch.utils.checkpoint import load_msgpack, save_msgpack
    from ladder_tpu_torch.utils.weights import torch_to_flax

    torch.set_num_threads(1)
    root = sys.argv[1]
    applied = {}   # the global gradients the step hands to Adam
    real_update = tstep._apply_update

    def recording(cfg, grads, opt_state, params, lr):
        applied.update({k: g.clone() for k, g in grads.items()})
        return real_update(cfg, grads, opt_state, params, lr)

    tstep._apply_update = recording
    mesh = make_mesh({"mesh_shape": [2]}, "cpu")
    rank, T = mesh.rank, torch.tensor
    cases = json.load(open(os.path.join(root, "cases.json")))

    def model_from(case, d):
        model = LadderModel(cases[case], seed=5)
        state = tstep.init_state(model, flax_state=d["state"], device="cpu")
        set_batchnorm_mesh(model, mesh)
        return model, state

    for case in cases:
        if case == "floor":
            continue
        d = load_msgpack(os.path.join(root, case + ".in.msgpack"))
        model, state = model_from(case, d)
        gm = d["gm"] and {k: T(v) for k, v in d["gm"].items()}
        noise = [{k: T(v) for k, v in n.items()} for n in d["noise"]]
        x = d["batch"][mesh.rows(d["batch"].shape[0])]
        applied.clear()
        fn = tstep.make_train_step(model, mesh)
        state, out = fn(state, x, None, gm, d["flags"], d["lrs"], True,
                        noise=noise)
        save_msgpack(os.path.join(root, f"{case}.out{rank}.msgpack"), dict(
            state=tstep.flax_state(state),
            grads=torch_to_flax(applied),
            loss=out["ae"]["loss_ae"].numpy()))

    d = load_msgpack(os.path.join(root, "floor.in.msgpack"))
    model, state = model_from("floor", d)
    model.double()
    noise = {k: T(v).double() for k, v in d["noise"].items()}
    x = T(d["batch"][mesh.rows(d["batch"].shape[0])]).permute(0, 3, 1, 2)
    loss, m = compute_loss(
        model, x.double(), gm={k: T(v).double() for k, v in d["gm"].items()},
        noise=tstep.local_noise(noise, mesh), mesh=mesh)
    params = dict(model.named_parameters())
    grads = tstep._gradients(loss, params, mesh)
    bn = BatchNormTrain(d["bn_x"].shape[1])
    bn.mesh = mesh
    bx = T(d["bn_x"][mesh.rows(d["bn_x"].shape[0])]).requires_grad_(True)
    y = bn(bx)
    w = T(d["bn_w"][mesh.rows(d["bn_w"].shape[0])])
    (y * w).sum().backward()
    bn_grads = {"x": bx.grad, "gamma": bn.gamma.grad, "beta": bn.beta.grad}
    mesh.average_([bn_grads["gamma"], bn_grads["beta"]])
    save_msgpack(os.path.join(root, f"floor.out{rank}.msgpack"), dict(
        grads={k: g.numpy() for k, g in grads.items()},
        sigma=m["sigma"].detach().numpy(),
        mpe=m["mean_pixel_error"].detach().numpy(),
        bn_y=y.detach().numpy(),
        bn_grads={k: g.numpy() for k, g in bn_grads.items()}))
''')


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``script`` started as ``world`` ranks of one gloo group (torchrun's
    environment, set by hand); ``outs(name)`` waits for them (raising with
    their output if one failed) and reads a case's per-rank outputs."""

    def __init__(self, script, root, world=WORLD):
        self.root, self.world, self.done = root, world, False
        port = _free_port()
        self.procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=str(ROOT))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(root)], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def wait(self, timeout=240):
        if not self.done:
            logs = [p.communicate(timeout=timeout)[0] for p in self.procs]
            self.done = True
            for p, log in zip(self.procs, logs):
                if p.returncode != 0:
                    raise AssertionError(
                        f"rank exited {p.returncode}:\n{log[-4000:]}")

    def outs(self, name):
        self.wait()
        return [load_msgpack(str(self.root / f"{name}.out{r}.msgpack"))
                for r in range(self.world)]


def _floor(state):
    """sigma below the model's mean pixel error: the floor is active."""
    state["params"]["sigma"] = {k: np.full_like(v, SIGMA) for k, v in
                                state["params"]["sigma"].items()}
    return state


def _seeded_state(cfg):
    """A flax-layout train state from the port's seeded weights (cheaper
    than JAX's eager init; both packages start from it)."""
    jmodel = jmake(cfg)
    params = jax.tree.map(jnp.asarray, LadderModel(cfg, seed=2).flax_params())
    jmodel.init = lambda rng: params
    return jmodel, jstep.init_state(jmodel, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write every case's inputs and start the 2-rank group once; the tests
    compute ladder_tpu's side while it runs."""
    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    cases, inputs = {}, {}
    for name, case in STEP_CASES.items():
        cfg = case["cfg"]()
        jmodel, jstate = _seeded_state(cfg)
        state = jax.tree.map(np.asarray, jstate)
        if cfg["exp_name"] == "celeba":
            _floor(state)
        calls = len(tstep.group_keys(cfg)) if name.endswith("_1") else 1
        d = dict(state=state,
                 batch=rng.random(case["shape"]).astype(np.float32),
                 noise=[noise_for(cfg, rng, batch=B) for _ in range(calls)],
                 gm=gm_for(cfg), flags=FLAGS, lrs=LRS)
        cases[name], inputs[name] = cfg, (jmodel, d)
        save_msgpack(str(root / f"{name}.in.msgpack"), d)
    cfg = make_config(batch_size=B)
    jmodel, jstate = _seeded_state(cfg)
    state = _floor(jax.tree.map(np.asarray, jstate))
    d = dict(state=state, batch=rng.random((B, 28, 28, 1)).astype(
                 np.float32),
             noise=noise_for(cfg, rng, batch=B), gm=gm_for(cfg),
             bn_x=rng.standard_normal(BN_SHAPE).astype(np.float32) * 3 + 1,
             bn_w=rng.standard_normal(BN_SHAPE).astype(np.float32))
    cases["floor"], inputs["floor"] = cfg, (None, d)
    save_msgpack(str(root / "floor.in.msgpack"), d)
    (root / "cases.json").write_text(json.dumps(cases))
    group = Ranks(WORKER, root)
    yield dict(cases=cases, inputs=inputs, outs=group.outs)
    group.wait()


@pytest.fixture(scope="module")
def jax_steps(ranks):
    """ladder_tpu's step of every case on a 2-device mesh: each traced in
    turn (the queue's draws become constants of its program), the four
    compiled side by side (XLA's compiles release the interpreter), then
    run. {case: (new state as numpy, out)}."""
    mesh = jmesh.make_mesh(devices=jax.devices()[:WORLD])
    lowered = {}
    with pytest.MonkeyPatch.context() as mp:
        queue = NoiseQueue(mp)
        for name in sorted(STEP_CASES):
            jmodel, d = ranks["inputs"][name]
            queue.feed(d["noise"])
            args = (jmesh.replicate(jax.tree.map(jnp.asarray, d["state"]),
                                    mesh),
                    jmesh.shard_batch(d["batch"], mesh),
                    jax.random.PRNGKey(0), jax_gm(d["gm"]),
                    {k: jnp.asarray(v) for k, v in FLAGS.items()}, LRS)
            fn = jstep.make_train_step(jmodel, jit=True)
            lowered[name] = (fn.lower(*args, do_prior=True), args)
            assert not queue.queue
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(lambda lw: lw[0].compile(),
                                              lowered.values())))
    out = {}
    for name, (_, args) in lowered.items():
        new, metrics = compiled[name](*args)
        out[name] = (jax.tree.map(np.asarray, new), metrics)
    return out


def _leaves(tree):
    return [(jax.tree_util.keystr(k), np.asarray(v))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_two_rank_step_matches_jax_mesh(ranks, jax_steps, name):
    want, jout = jax_steps[name]
    hold_ranks_step(ranks["cases"][name], want, jout, ranks["outs"](name))


def hold_ranks_step(cfg, want, jout, outs):
    """The ranks' outputs of one step (their loss, their gathered state,
    the gradients they applied) against ladder_tpu's new state and
    metrics, at the bounds of the module docstring."""
    for got in outs:
        np.testing.assert_allclose(got["loss"], np.asarray(
            jout["ae"]["loss_ae"]), rtol=1e-5)
    # the ranks applied the same update: bitwise equal states
    for other in outs[1:]:
        for (_, a), (_, b) in zip(_leaves(outs[0]["state"]),
                                  _leaves(other["state"])):
            np.testing.assert_array_equal(a, b)
    got = outs[0]["state"]
    assert jax.tree.structure(got["params"]) == jax.tree.structure(
        want["params"])
    # the gradient each package applied: the port's as the ranks handed it
    # to Adam, ladder_tpu's from its first moment (m = 0.1 * the clipped
    # gradient after one step: the same sign)
    grads = dict(_leaves(outs[0]["grads"]))
    moments = {}
    for group in want["opt"].values():
        moments.update(_leaves(group["m"]))
    got_p, want_p = dict(_leaves(got["params"])), dict(
        _leaves(want["params"]))
    assert set(grads) == set(got_p)
    for names in tstep.group_keys(cfg).values():
        paths = [p for p in grads if p.split("'")[1] in names]
        top = max(np.abs(grads[p]).max() for p in paths)
        flips = {p: np.sign(grads[p]) != np.sign(moments[p]) for p in paths}
        # apart from the elements whose true gradient is zero, few flip
        rest = [(f & ~zero_gradient_mask(p, f)) for p, f in flips.items()]
        share = sum(f.sum() for f in rest) / sum(f.size for f in rest)
        assert share <= 1e-3, (names, share)
        for p in paths:
            # only gradients at rounding level change sign
            assert (np.abs(grads[p])[flips[p]] <= ROUNDING * top).all(), p
            noise = flips[p] | zero_gradient_mask(p, grads[p])
            np.testing.assert_allclose(got_p[p][~noise], want_p[p][~noise],
                                       rtol=5e-3, atol=1e-5, err_msg=p)
            assert (np.abs(got_p[p] - want_p[p])[noise]
                    <= 2 * max(LRS.values())).all(), p


def _one_process_floor(ranks):
    """The floor case on one process over the whole batch."""
    cfg = ranks["cases"]["floor"]
    _, d = ranks["inputs"]["floor"]
    model = LadderModel(cfg, seed=5)
    tstep.init_state(model, flax_state=d["state"], device="cpu")
    model.double()
    x = torch.tensor(d["batch"]).permute(0, 3, 1, 2).double()
    loss, m = compute_loss(
        model, x, gm={k: torch.tensor(v).double() for k, v in d["gm"].items()},
        noise={k: torch.tensor(v).double() for k, v in d["noise"].items()})
    params = dict(model.named_parameters())
    return tstep._gradients(loss, params), m


def test_sigma_floor_gradient_matches_one_process(ranks):
    grads, m = _one_process_floor(ranks)
    outs = ranks["outs"]("floor")
    assert m["mean_pixel_error"].item() > SIGMA  # the floor is active
    for got in outs:
        np.testing.assert_allclose(got["mpe"], m["mean_pixel_error"].item(),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["sigma"], m["sigma"].item(),
                                   rtol=1e-6)
    for name, want in grads.items():
        want = want.numpy()
        scale = max(np.abs(want).max(), 1e-30)
        for got in outs:
            err = np.abs(got["grads"][name] - want).max() / scale
            assert err <= 1e-6, (name, err)


def test_global_batchnorm_matches_one_process(ranks):
    _, d = ranks["inputs"]["floor"]
    bn = BatchNormTrain(BN_SHAPE[1])
    x = torch.tensor(d["bn_x"]).requires_grad_(True)
    y = bn(x)
    (y * torch.tensor(d["bn_w"])).sum().backward()
    outs = ranks["outs"]("floor")
    got_y = np.concatenate([o["bn_y"] for o in outs])
    np.testing.assert_allclose(got_y, y.detach().numpy(), rtol=0, atol=1e-6)
    got_dx = np.concatenate([o["bn_grads"]["x"] for o in outs])
    np.testing.assert_allclose(got_dx, x.grad.numpy(), rtol=0, atol=1e-6)
    for name, p in (("gamma", bn.gamma), ("beta", bn.beta)):
        for o in outs:
            # each rank's parameter gradient, averaged: the global sum / 2
            np.testing.assert_allclose(o["bn_grads"][name] * WORLD,
                                       p.grad.numpy(), rtol=1e-6, atol=1e-6)


# ---- the mesh module's rules, in this process ---------------------------

@pytest.mark.parametrize("shape, world, error, match", [
    (None, 2, None, None),
    ([8], 2, None, None),
    ([2], 2, None, None),
    ([1], 2, ValueError, "nothing to do"),
    ([2, 2], 1, None, None),      # one rank: its one device
    ([2, 2], 4, None, None),
    ([4, 2], 6, None, None),      # 3 of the 4 data groups
    ([1, 2], 2, None, None),
    ([2, 2], 3, ValueError, "not a multiple of n_model"),
    ([2, 3], 4, ValueError, "not a multiple of n_model"),
    ([2, 2], 8, ValueError, "nothing to do"),
    ([1, 2], 4, ValueError, "nothing to do"),
    ([2, 2, 2], 1, ValueError, "3 axes"),
])
def test_mesh_shape_rules(shape, world, error, match):
    if error is None:
        tmesh.check_mesh_shape(shape, world)
    else:
        with pytest.raises(error, match=match):
            tmesh.check_mesh_shape(shape, world)


def test_place_global_batch_and_stack_rows_and_reject_indivisible():
    """Rows [r*B/R, (r+1)*B/R) of the batch (axis 1 of a stack), and a
    loud failure when the batch does not divide (tests/test_parallel.py:
    310-323's rule)."""
    batch = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    stack = np.stack([batch, batch + 100])
    for rank in range(2):
        mesh = tmesh.DataMesh(rank, 2, "cpu")
        rows = slice(8 * rank, 8 * rank + 8)
        np.testing.assert_array_equal(
            tmesh.place_global_batch(batch, mesh).numpy(), batch[rows])
        np.testing.assert_array_equal(
            tmesh.place_global_stack(stack, mesh).numpy(), stack[:, rows])
    mesh = tmesh.DataMesh(0, 3, "cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.place_global_batch(batch, mesh)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.place_global_stack(stack, mesh)
    with mesh.whole_batch():  # sharding off: the batch itself
        assert tmesh.shard_batch(batch, mesh) is batch


@pytest.mark.parametrize("n, multiple", [(16, 8), (13, 8), (5, 8), (1, 4),
                                         (7, 3)])
def test_pad_to_multiple_matches_jax(n, multiple):
    batch = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got, real = tmesh.pad_to_multiple(batch, multiple)
    want, want_real = jmesh.pad_to_multiple(batch, multiple)
    assert real == want_real == n
    np.testing.assert_array_equal(got, want)


def test_randn_rows_keep_the_global_draws_rows():
    """Every rank draws the global batch's noise from the same generator
    and keeps its rows: the rows concatenate to one process's draws, and
    the generators end in the same state."""
    want = tmesh.randn_rows(torch.Generator().manual_seed(3), (2, 6, 3),
                            axis=1)
    parts, states = [], []
    for rank in range(2):
        g = torch.Generator().manual_seed(3)
        parts.append(tmesh.randn_rows(g, (2, 3, 3),
                                      tmesh.DataMesh(rank, 2, "cpu"), axis=1))
        states.append(g.get_state())
    assert torch.equal(torch.cat(parts, dim=1), want)
    assert torch.equal(states[0], states[1])


def test_two_nccl_ranks_on_one_card_raise():
    """The duplicate-card check behind make_mesh's NCCL path."""
    tmesh._distinct_devices(["host/GPU-a", "host/GPU-b"])
    with pytest.raises(RuntimeError, match="same card"):
        tmesh._distinct_devices(["host/GPU-a", "host/GPU-a"])


def test_trace_summary_of_the_steps_after_the_first():
    """utils/profiling.py:summarise: the window from the second step's start
    to the last device event, the union of the device's intervals in it,
    the copies, and the collectives' host time by name."""
    from ladder_tpu_torch.utils.profiling import STEP_MARK, summarise

    events = [
        (STEP_MARK + "0", False, 0.0, 50.0),
        ("kernel_a", True, 10.0, 60.0),        # step 0's, clipped at 100
        (STEP_MARK + "1", False, 100.0, 200.0),
        (STEP_MARK + "1", True, 110.0, 200.0),  # the mark's device span
        ("kernel_b", True, 120.0, 160.0),
        ("kernel_c", True, 150.0, 180.0),      # overlaps b: union 60 us
        ("Memcpy DtoH (Device -> Pinned)", True, 190.0, 200.0),
        ("gloo:all_reduce", False, 185.0, 195.0),
        (STEP_MARK + "2", False, 200.0, 300.0),
        ("Memcpy HtoD (Pinned -> Device)", True, 300.0, 320.0),
        ("c10d::allreduce_", False, 250.0, 270.0),
        ("aten::add", False, 210.0, 211.0),
    ]
    got = summarise(events)
    assert got["steps"] == 2
    assert got["wall_ms"] == pytest.approx(0.22)          # 100 .. 320 us
    assert got["device_busy_ms"] == pytest.approx(0.09)   # 60 + 10 + 20
    assert got["idle_share"] == pytest.approx(1 - 90 / 220)
    assert got["copy_ms"] == pytest.approx(0.03)
    assert got["collectives_ms"] == {"gloo:all_reduce": [1, 0.01],
                                     "c10d::allreduce_": [1, 0.02]}
    assert summarise([(STEP_MARK + "0", False, 0.0, 1.0)]) is None
