"""The (data, model) mesh of the port (ladder_tpu_torch/parallel/tp.py:
parameters and Adam moments sharded over the model axis) against
ladder_tpu's tensor-parallel mesh (ladder_tpu/parallel/tp.py).

  * leaf_spec over every leaf of a small CelebA and a small mnist_digit
    tree at n_model 2, 3 and 4: the port's axis, mapped back through the
    weight bridge's layouts (utils/weights.py), is ladder_tpu's, each rank
    holds the same bytes, and every shard is the bridge's image of
    ladder_tpu's shard (the flattened-input dense kernels included, whose
    rows the bridge permutes: they shard on their output axis);
  * one 4-rank gloo group (2 x 2, two threads each), started once for the
    module, runs one train step in modes 1 and 2 for a small mnist_digit
    'ours' and a small CelebA (h=16) model against ladder_tpu's step on its
    4 x 2 make_mesh_2d with shard_state, from the same weights, batch, GM
    and fed noise, at ladder_tpu's own bounds (tests/
    test_tensor_parallel.py:117-122: the loss rtol 1e-5, the parameters
    rtol 5e-3 atol 1e-5) with tests/test_torch_parallel.py's zero-gradient
    and sign-flip exceptions; the ranks' gathered states are bitwise equal;
  * the memory invariant of tests/test_tensor_parallel.py:208-244: each
    rank's bytes of parameters and moments at rest equal ladder_tpu's
    prediction exactly and are at most 0.55 of the replicated total;
  * the full-state round trip of tests/test_tensor_parallel.py:247-288 on
    mesh_shape [1, 2] (ranks 0 and 1 of the group): the resumed trainer
    holds the same shards in the same layout and trains on, and the files
    of both epochs (the second through the asynchronous writer) are byte
    for byte a one-process save of the state assembled from the ranks'
    shards.
"""

import copy
import json
import os
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import ladder_tpu.parallel.mesh as jmesh
import ladder_tpu.parallel.tp as jtp
import ladder_tpu.training.step as jstep
from ladder_tpu_torch.models.builder import LadderModel
from ladder_tpu_torch.parallel import tp as ttp
from ladder_tpu_torch.training import step as tstep
from ladder_tpu_torch.training.optim import adam_init, adam_update
from ladder_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    load_msgpack,
    save_msgpack,
)
from ladder_tpu_torch.utils.weights import flax_to_torch
from tests.conftest import make_config
from tests.test_torch_losses import (
    NoiseQueue,
    few_threads,  # noqa: F401  (autouse fixture: two torch threads)
    gm_for,
    jax_gm,
    noise_for,
    small_celeba,
)
from tests.test_torch_parallel import (
    FLAGS,
    Ranks,
    _floor,
    _seeded_state,
    hold_ranks_step,
)
from tests.test_torch_train_step import LRS

B = 8          # global batch: 2 rows per rank
WORLD = 4
N_MODEL = 2
STEP_CASES = {
    "mnist_1": dict(cfg=lambda: make_config(batch_size=B,
                                            fused_train_step=1),
                    shape=(B, 28, 28, 1)),
    "mnist_2": dict(cfg=lambda: make_config(batch_size=B,
                                            fused_train_step=2),
                    shape=(B, 28, 28, 1)),
    "celeba_1": dict(cfg=lambda: dict(small_celeba(
        "standard_gaussian", fused_train_step=1), batch_size=B),
        shape=(B, 128, 128, 3)),
    "celeba_2": dict(cfg=lambda: dict(small_celeba(
        "standard_gaussian", fused_train_step=2), batch_size=B),
        shape=(B, 128, 128, 3)),
}
# tests/test_tensor_parallel.py:208-244's model
MEMORY_CFG = dict(prior="ours", batch_size=16, n_MC_samples=4, n_mixtures=3,
                  num_hidden_units=64, num_hidden_units_inner_VAE=16,
                  n_layers_inner_VAE=2)
# tests/test_tensor_parallel.py:247-288's trainer, on mesh_shape [1, 2]
ROUND_TRIP_CFG = dict(prior="ours", sg_pretraining=0, accurate_fit=5,
                      n_MC_samples=4, n_mixtures=3, num_hidden_units=64,
                      num_hidden_units_inner_VAE=16, n_layers_inner_VAE=2,
                      enable_plots=0, synthetic_n_train=128,
                      synthetic_n_test=64, batch_size=32, mesh_shape=[1, 2])
PROBE = "encoder.Conv_2.weight"

WORKER = textwrap.dedent('''
    import json, os, shutil, sys
    import numpy as np, torch
    import torch.distributed as dist
    from ladder_tpu_torch.data.mnist import DataGenerator
    from ladder_tpu_torch.models.builder import LadderModel
    from ladder_tpu_torch.models.layers import set_batchnorm_mesh
    from ladder_tpu_torch.parallel.mesh import Mesh2D, make_mesh, shard_state
    from ladder_tpu_torch.training import step as tstep
    from ladder_tpu_torch.training.trainer import MNISTTrainer
    from ladder_tpu_torch.utils.checkpoint import load_msgpack, save_msgpack
    from ladder_tpu_torch.utils.weights import torch_to_flax

    torch.set_num_threads(2)
    root = sys.argv[1]
    applied = {}   # the averaged full gradients each group update is given
    real_update = tstep._update_group

    def recording(cfg, state, name, grads, params, lr, mesh):
        applied.update({k: g.clone() for k, g in grads.items()})
        return real_update(cfg, state, name, grads, params, lr, mesh)

    tstep._update_group = recording
    mesh = make_mesh({"mesh_shape": [2, 2]}, "cpu")
    rank, T = mesh.rank, torch.tensor
    cases = json.load(open(os.path.join(root, "cases.json")))

    def shards(state):
        tp = state["tp"]
        # copies: the shards are updated in place later
        return dict(params={k: s.numpy().copy()
                            for k, s in tp.shards.items()},
                    opt={g: {m: {k: s.numpy().copy()
                                 for k, s in o[m].items()}
                             for m in ("m", "v")} | {"t": o["t"]}
                         for g, o in state["opt"].items()},
                    step=state["step"])

    for case in cases["steps"]:
        d = load_msgpack(os.path.join(root, case + ".in.msgpack"))
        model = LadderModel(cases["steps"][case], seed=5)
        state = tstep.init_state(model, flax_state=d["state"], device="cpu")
        set_batchnorm_mesh(model, mesh)
        shard_state(state, mesh)
        gm = d["gm"] and {k: T(v) for k, v in d["gm"].items()}
        noise = [{k: T(v) for k, v in n.items()} for n in d["noise"]]
        x = d["batch"][mesh.rows(d["batch"].shape[0])]
        applied.clear()
        fn = tstep.make_train_step(model, mesh)
        state, out = fn(state, x, None, gm, d["flags"], d["lrs"], True,
                        noise=noise)
        at_rest = state["tp"].held_bytes()
        save_msgpack(os.path.join(root, f"{case}.out{rank}.msgpack"), dict(
            state=tstep.flax_state(state), grads=torch_to_flax(applied),
            loss=out["ae"]["loss_ae"].numpy(), at_rest=at_rest,
            gathers=mesh.stats["param_gather"]["calls"]))

    # the memory invariant
    model = LadderModel(cases["memory"], seed=0)
    state = tstep.init_state(model, device="cpu")
    tp = shard_state(state, mesh)
    empty = sum(p.numel() for k, p in model.named_parameters()
                if tp.specs[k] is not None)
    save_msgpack(os.path.join(root, f"memory.out{rank}.msgpack"), dict(
        held=tp.held_bytes(), predicted=tp.predicted_bytes()[0],
        replicated=tp.predicted_bytes()[1], empty=empty,
        specs={k: -1 if a is None else a for k, a in tp.specs.items()}))

    # the round trip on mesh_shape [1, 2]: ranks 0 and 1
    pair = dist.new_group([0, 1])
    if rank < 2:
        pmesh = Mesh2D(rank, 2, "cpu", 2, model_group=pair, group=pair,
                       backend="gloo")

        def build(epochs, **kw):
            cfg = dict(cases["round_trip"], num_epochs=epochs, **kw)
            return MNISTTrainer(LadderModel(cfg, seed=0), DataGenerator(cfg),
                                cfg, device="cpu", mesh=pmesh)

        t1 = build(1)
        t1.train()
        save_msgpack(os.path.join(root, f"rt1.shards{rank}.msgpack"),
                     shards(t1.state))
        if rank == 0:
            shutil.copytree(cases["round_trip"]["checkpoint_dir"],
                            os.path.join(root, "epoch1"))
        pmesh.barrier()
        t2 = build(2, async_checkpoint=1)
        t2.restore()
        restored = shards(t2.state)
        t2.train()
        save_msgpack(os.path.join(root, f"rt2.out{rank}.msgpack"), dict(
            restored=restored, cur_epoch=[t1.cur_epoch, t2.cur_epoch],
            specs={k: -1 if a is None else a
                   for k, a in t2.tp.specs.items()},
            train_loss=np.asarray(t2.metrics.train_loss),
            sharded=[t.tp is not None for t in (t1, t2)]))
        save_msgpack(os.path.join(root, f"rt2.shards{rank}.msgpack"),
                     shards(t2.state))
    dist.barrier()
''')


# ---- leaf_spec, in this process -----------------------------------------

def _trees():
    """Small flax-layout parameter trees of both families, from the port's
    seeded weights."""
    celeba = small_celeba("ours")
    mnist = make_config()
    return {"celeba": (celeba, LadderModel(celeba, seed=0).flax_params()),
            "mnist": (mnist, LadderModel(mnist, seed=0).flax_params())}


TREES = _trees()


def _flax_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flax_leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _torch_key(path):
    return ".".join(path[:-1] + ("weight" if path[-1] == "kernel"
                                 else path[-1],))


def _flax_axis(spec):
    axes = [i for i, a in enumerate(spec) if a == jtp.MODEL_AXIS]
    return axes[0] if axes else None


def _to_flax_axis(axis, ndim, weight):
    """The port's axis -> the flax layout's (OIHW -> HWIO, [out, in] ->
    [in, out])."""
    if axis is None or not weight:
        return axis
    return {4: {0: 3, 1: 2}, 2: {0: 1, 1: 0}}[ndim][axis]


def _with_leaf(tree, path, leaf):
    tree = copy.deepcopy(tree)
    node = tree
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = leaf
    return tree


@pytest.mark.parametrize("n_model", [2, 3, 4])
@pytest.mark.parametrize("family", sorted(TREES))
def test_leaf_spec_matches_ladder_tpu(family, n_model):
    cfg, tree = TREES[family]
    state = flax_to_torch(tree)
    sharded = 0
    for path, leaf in _flax_leaves(tree):
        key = _torch_key(path)
        t = state[key]
        weight = ttp.is_weight(key, torch.as_tensor(t))
        assert weight == (path[-1] == "kernel"), key
        axis = ttp.leaf_spec(t.shape, n_model, weight)
        want = _flax_axis(jtp.leaf_spec(leaf.shape, n_model))
        assert _to_flax_axis(axis, t.ndim, weight) == want, key
        per_rank = t.nbytes // n_model if axis is not None else t.nbytes
        assert per_rank == (leaf.nbytes // n_model if want is not None
                            else leaf.nbytes), key
        if axis is None:
            continue
        sharded += 1
        # each shard is the bridge's image of ladder_tpu's shard
        for i in range(n_model):
            mine = np.split(t, n_model, axis=axis)[i]
            theirs = np.split(leaf, n_model, axis=want)[i]
            image = flax_to_torch(_with_leaf(tree, path, theirs))[key]
            np.testing.assert_array_equal(mine, image, err_msg=key)
    if n_model != 3:  # at 3 the mnist widths all replicate
        assert sharded


def test_flattened_input_kernels_shard_on_their_output():
    """The dense kernels whose rows the bridge permutes (code_mean,
    code_std_dev, mnist Dense_0) shard on their output axis at n_model 2:
    the permutation never crosses a shard."""
    for family, names in (("celeba", ("code_mean", "code_std_dev")),
                          ("mnist", ("Dense_0",))):
        cfg, tree = TREES[family]
        state = flax_to_torch(tree)
        for name in names:
            t = state[f"encoder.{name}.weight"]
            assert ttp.leaf_spec(t.shape, 2, weight=True) == 0, name


def test_leaf_spec_never_shards_conv_spatial_axes():
    """tests/test_tensor_parallel.py:47-57 in the port's OIHW layout: a
    3-wide spatial axis never shards, the input channels remain a
    fallback, 5-D leaves take the trailing-two-axes rule."""
    assert ttp.leaf_spec((31, 16, 3, 3), 3, weight=True) is None
    assert ttp.leaf_spec((32, 16, 3, 3), 3, weight=True) is None
    assert ttp.leaf_spec((32, 15, 3, 3), 3, weight=True) == 1
    assert ttp.leaf_spec((4, 3, 3, 8, 31), 4) == 3
    # and ladder_tpu's own cases, on leaves that keep their layout
    for shape, n in (((3, 3, 16, 31), 3), ((16, 3), 2), ((3, 5), 2),
                     ((1, 1), 2), ((), 2), ((32,), 2), ((64, 128), 1)):
        assert ttp.leaf_spec(shape, n) == _flax_axis(jtp.leaf_spec(shape,
                                                                   n))


class _LocalGroup:
    """The model axis of n ranks in one process: gather_model returns the
    ranks' tensors (set by the test) for the shapes of this rank's."""

    def __init__(self, parts):
        self.parts = parts

    def gather_model(self, flat):
        return [p for p in self.parts]


def test_shard_and_gather_round_trip():
    """shard_params_tp then gather_params_tp gives every tensor back, bit
    for bit; the shards are contiguous new tensors, a fallback axis too."""
    g = torch.Generator().manual_seed(0)
    full = {"a.weight": torch.randn(6, 4, 3, 3, generator=g),
            "b.weight": torch.randn(3, 8, generator=g),   # axis 1
            "c.bias": torch.randn(6, generator=g),
            "d.scalar": torch.randn((), generator=g)}
    specs = {k: ttp.leaf_spec(t.shape, 2, ttp.is_weight(k, t))
             for k, t in full.items()}
    assert specs == {"a.weight": 0, "b.weight": 1, "c.bias": 0,
                     "d.scalar": None}
    ranks = [ttp.shard_params_tp(full, specs, i, 2) for i in range(2)]
    for shards in ranks:
        assert all(s.is_contiguous() for s in shards.values())
        assert shards["b.weight"].shape == (3, 4)
    flats = [torch.cat([r[k].reshape(-1) for k in full if specs[k] is not None])
             for r in ranks]
    got = ttp.gather_params_tp(ranks[0], specs, _LocalGroup(flats))
    for k, t in full.items():
        assert torch.equal(got[k], t), k


def test_adam_on_shards_is_the_update_restricted_to_them():
    """The clip is elementwise: each rank's update of its shards (the plain
    version, as on the CPU) is the whole update restricted to them."""
    g = torch.Generator().manual_seed(1)
    params = {"w.weight": torch.randn(8, 6, generator=g),
              "v.weight": torch.randn(3, 4, generator=g),
              "s": torch.randn((), generator=g)}
    grads = {k: 3 * torch.randn(p.shape, generator=g)
             for k, p in params.items()}
    specs = {k: ttp.leaf_spec(p.shape, 2, ttp.is_weight(k, p))
             for k, p in params.items()}
    whole = {k: p.clone() for k, p in params.items()}
    state = adam_init(whole)
    for _ in range(3):
        adam_update(grads, state, whole, 1e-2)
    for i in range(2):
        mine = ttp.shard_params_tp(params, specs, i, 2)
        my_grads = ttp.shard_params_tp(grads, specs, i, 2, copy=False)
        my_state = adam_init(mine)
        for _ in range(3):
            adam_update(my_grads, my_state, mine, 1e-2)
        want = ttp.shard_params_tp(whole, specs, i, 2)
        for k in params:
            assert torch.equal(mine[k], want[k]), k
            assert torch.equal(my_state["v"][k], ttp.shard_params_tp(
                state["v"], specs, i, 2)[k]), k


# ---- the 4-rank group -----------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write every case's inputs and start the 2 x 2 group once; the tests
    compute ladder_tpu's side while it runs."""
    root = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    steps, inputs = {}, {}
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
        steps[name], inputs[name] = cfg, (jmodel, d)
        save_msgpack(str(root / f"{name}.in.msgpack"), d)
    rt = make_config(**ROUND_TRIP_CFG)
    rt["result_dir"] = str(root / "result") + "/"
    rt["checkpoint_dir"] = str(root / "ckpt") + "/"
    os.makedirs(rt["result_dir"])
    os.makedirs(rt["checkpoint_dir"])
    cases = dict(steps=steps, memory=make_config(**MEMORY_CFG),
                 round_trip=rt)
    (root / "cases.json").write_text(json.dumps(cases))
    group = Ranks(WORKER, root, world=WORLD)
    yield dict(cases=cases, inputs=inputs, outs=group.outs, root=root,
               wait=group.wait)
    group.wait()


@pytest.fixture(scope="module")
def jax_steps(ranks):
    """ladder_tpu's step of every case on its 4 x 2 mesh with the state
    sharded over the model axis: each traced in turn (the queue's draws
    become constants of its program), compiled side by side, then run."""
    mesh = jtp.make_mesh_2d(n_data=WORLD, n_model=N_MODEL)
    lowered = {}
    with pytest.MonkeyPatch.context() as mp:
        queue = NoiseQueue(mp)
        for name in sorted(STEP_CASES):
            jmodel, d = ranks["inputs"][name]
            queue.feed(d["noise"])
            args = (jmesh.shard_state(jax.tree.map(jnp.asarray, d["state"]),
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


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_tp_step_matches_jax_tp_mesh(ranks, jax_steps, name):
    """Four ranks (2 x 2) against ladder_tpu's 4 x 2 tensor-parallel step;
    the gathered states of all four ranks bitwise equal."""
    want, jout = jax_steps[name]
    outs = ranks["outs"](name)
    hold_ranks_step(ranks["cases"]["steps"][name], want, jout, outs)
    # at rest after the step: the shards only, the same on every rank
    assert len({int(o["at_rest"]) for o in outs}) == 1
    # a gather before the first forward, and in mode 1 one before each
    # sub-step after an update of a sharded group
    gathers = {int(o["gathers"]) for o in outs}
    assert len(gathers) == 1 and gathers.pop() >= 1


def test_ranks_hold_their_shards(ranks):
    """tests/test_tensor_parallel.py:208-244: per rank, the bytes of
    parameters and Adam moments at rest equal ladder_tpu's prediction for
    its layout exactly, and are at most 0.55 of the replicated total; the
    sharded parameters hold no storage at rest."""
    cfg = ranks["cases"]["memory"]
    _, jstate = _seeded_state(cfg)
    trees = [jstate["params"]] + [jstate["opt"][g][k] for g in jstate["opt"]
                                  for k in ("m", "v")]
    leaves = [leaf for t in trees for leaf in jax.tree.leaves(t)]
    replicated = sum(np.asarray(x).nbytes for x in leaves)
    expected = sum(np.asarray(x).nbytes // N_MODEL
                   if jtp.leaf_spec(np.shape(x), N_MODEL) != P()
                   else np.asarray(x).nbytes for x in leaves)
    for out in ranks["outs"]("memory"):
        assert int(out["held"]) == int(out["predicted"]) == expected
        assert int(out["replicated"]) == replicated
        assert int(out["held"]) <= 0.55 * replicated, (out["held"],
                                                       replicated)
        assert int(out["empty"]) == 0
        assert int(out["specs"][PROBE]) == 0   # output channels


def _assemble(root, name, cfg):
    """The ranks' shards of one round-trip epoch -> a one-process train
    state (a new LadderModel with those parameters and moments)."""
    parts = [load_msgpack(str(root / f"{name}.shards{r}.msgpack"))
             for r in range(2)]
    model = LadderModel(cfg, seed=0)
    state = tstep.init_state(model, device="cpu")
    params = dict(model.named_parameters())

    def join(key, pieces):
        axis = ttp.leaf_spec(params[key].shape, 2,
                             ttp.is_weight(key, params[key]))
        if axis is None:
            np.testing.assert_array_equal(pieces[0], pieces[1])
            return torch.tensor(pieces[0])
        return torch.tensor(np.concatenate(pieces, axis=axis))

    with torch.no_grad():
        for k, p in params.items():
            p.copy_(join(k, [q["params"][k] for q in parts]))
        for g, group in state["opt"].items():
            for m in ("m", "v"):
                for k, t in group[m].items():
                    t.copy_(join(k, [q["opt"][g][m][k] for q in parts]))
            group["t"] = int(parts[0]["opt"][g]["t"])
    state["step"] = int(parts[0]["step"])
    return state


@pytest.mark.parametrize("epoch, writer", [(1, "sync"), (2, "async")])
def test_tp_checkpoint_is_a_one_process_save(ranks, tmp_path, epoch,
                                             writer):
    """The files the lead of a [1, 2] mesh wrote (epoch 1 synchronously,
    epoch 2 through the asynchronous writer) are byte for byte a
    one-process save of the state assembled from the ranks' shards."""
    ranks["wait"]()
    root = ranks["root"]
    cfg = ranks["cases"]["round_trip"]
    written = root / "epoch1" if epoch == 1 else Path(cfg["checkpoint_dir"])
    state = _assemble(root, f"rt{epoch}", cfg)
    one = dict(cfg, checkpoint_dir=str(tmp_path) + "/")
    CheckpointManager(one).save(state["model"].flax_params(), model="joint")
    for name in ("vae-model.msgpack", "prior-model.msgpack"):
        assert (tmp_path / name).read_bytes() == (written /
                                                  name).read_bytes(), name
    extra = load_msgpack(str(written / "train-state.msgpack"))["extra"]
    save_msgpack(str(tmp_path / "train-state.msgpack"),
                 {"state": tstep.flax_state(state), "extra": extra})
    assert (tmp_path / "train-state.msgpack").read_bytes() == (
        written / "train-state.msgpack").read_bytes()


def test_tp_round_trip_keeps_the_layout(ranks):
    """tests/test_tensor_parallel.py:247-288: the resumed trainer is
    sharded again, holds epoch 1's shards in epoch 1's layout (parameters
    and moments), and trains another epoch to finite losses."""
    root = ranks["root"]
    for rank in range(2):
        out = load_msgpack(str(root / f"rt2.out{rank}.msgpack"))
        before = load_msgpack(str(root / f"rt1.shards{rank}.msgpack"))
        assert [int(e) for e in out["cur_epoch"]] == [1, 2]
        assert list(map(bool, out["sharded"])) == [True, True]
        assert int(out["specs"][PROBE]) == 0
        restored = out["restored"]
        assert restored["params"][PROBE].shape == before["params"][PROBE].shape
        for k, v in before["params"].items():
            np.testing.assert_array_equal(restored["params"][k], v, k)
        for g, group in before["opt"].items():
            for m in ("m", "v"):
                for k, v in group[m].items():
                    np.testing.assert_array_equal(
                        restored["opt"][g][m][k], v, f"{g}/{m}/{k}")
        loss = np.asarray(out["train_loss"])
        assert loss.size == 2 * (ROUND_TRIP_CFG["synthetic_n_train"]
                                 // ROUND_TRIP_CFG["batch_size"])
        assert np.isfinite(loss).all()
