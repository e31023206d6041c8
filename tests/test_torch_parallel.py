"""videoglamm_torch.parallel and the sharded train step on the CPU: the
mesh, the partition rules and the ZeRO-2 moment specs against the JAX
package's, and the sharded step over gloo against the port's one-process
step and against JAX's `make_sharded_train_step`.

One group of four processes (gloo, one time limit for the group) runs
every multi-process case, meshes over disjoint rank sets side by side:

- (2, 2) over ranks 0-3, two f32 steps;
- then (2, 1) over ranks 0-1 and (1, 2) over ranks 2-3, two steps each and
  a checkpoint of each;
- then (2, 1) with grad_accum=2 beside serving at (1, 2), with the float
  and the int8 KV cache;
- then serving at (2, 1) beside a (1, 2) step of a Phi-3 whose vocabulary
  (511 + [SEG] = 512) divides, so its embedding and lm_head are
  vocab-parallel.

The JAX tree is `VideoGLaMMConfig.tiny()` with `lora_rank=2`, filled from
a numpy seed and carried over by `io/from_jax.py`; the batch has two
videos and four rows (`make_batch(Bv=2, R=4)`), so each data rank takes
one video and its two rows.

Tolerances (those of tests/test_torch_training.py): loss components 1e-5
relative; parameters after two steps 2e-3 absolute everywhere (lr 1e-3:
where a gradient entry is rounding, Adam's normalised update flips sign)
and 5e-5 on the entries whose first gradient is at least a tenth of its
leaf's largest; frozen leaves bit-identical. The split of the losses: the
ranks' losses sum to the one-process loss to 1e-6 relative.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import seeded_params
from test_torch_training import JTCFG, LORA_RANK, METRICS, TCFG, _torch_batch
from test_videoglamm import CFG, make_batch
from videoglamm_tpu.models import VideoGLaMM as JVideoGLaMM
from videoglamm_tpu.parallel import create_mesh as jcreate_mesh
from videoglamm_tpu.parallel.partitioning import (
    _divisible as jdivisible, param_partition_spec as jparam_partition_spec)
from videoglamm_tpu.training import (create_train_state as jcreate_state,
                                     make_optimizer as jmake_optimizer,
                                     make_sharded_train_step as jsharded_step)
from videoglamm_tpu.training.train_step import (
    opt_state_partition_spec as jopt_state_partition_spec)
from videoglamm_torch.inference.pipeline import GroundedInference
from videoglamm_torch.io.checkpoint import CheckpointManager
from videoglamm_torch.io.from_jax import port_config, videoglamm_state_dict
from videoglamm_torch.models.videoglamm import VideoGLaMM
from videoglamm_torch.parallel import (create_mesh, local_mesh,
                                       param_partition_spec, with_sharding)
from videoglamm_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Axis
from videoglamm_torch.training import (build_training, create_train_state,
                                       make_sharded_train_step,
                                       opt_state_partition_spec, split_batch)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PCFG = port_config(CFG)
GROUP_TIMEOUT = 120
MAX_NEW = 6
EOS = 3
TOL_PARAM, TOL_CLEAR = 2e-3, 5e-5
MESH2 = types.SimpleNamespace(shape={DATA_AXIS: 2, MODEL_AXIS: 2})


def _vocab_cfg(cfg):
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                            vocab_size=511))


WORKER = r"""
import sys
for name in ("jax", "flax", "optax", "videoglamm_tpu"):
    sys.modules[name] = None
import dataclasses, json
import torch
torch.set_num_threads(1)
from videoglamm_torch.inference.pipeline import GroundedInference
from videoglamm_torch.io.checkpoint import CheckpointManager
from videoglamm_torch.models.videoglamm import VideoGLaMM
from videoglamm_torch.parallel import (create_mesh, full_state_dict,
                                       initialize_distributed, shard_params)
from videoglamm_torch.training import build_training, make_sharded_train_step

rank, addr, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
initialize_distributed(addr, 4, rank, device="cpu")
inp = torch.load(d + "/inputs.pt", weights_only=False)


def train(mesh, tag, batch, grad_accum=1, cfg=inp["cfg"], sd=inp["sd"],
          ckpt=False):
    tcfg = dataclasses.replace(inp["tcfg"], grad_accum_steps=grad_accum)
    tr = build_training(cfg, tcfg, sd, device="cpu", dtype=torch.float32)
    step, state, split = make_sharded_train_step(tr.model, tr.tx, mesh,
                                                 tr.state, grad_accum=grad_accum)
    local = split(batch)
    metrics = []
    for _ in range(2):
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    out = dict(metrics=metrics, params=full_state_dict(tr.model),
               split="ce_norm" in local,
               n_model_split=len(state.sharding.model),
               n_data_split=len(state.sharding.data))
    if ckpt:
        mgr = CheckpointManager(f"{d}/ckpt_{tag}")
        before = {n: p.detach().clone() for n, p in state.params.items()}
        mu = {n: m.clone() for n, m in state.opt_state["mu"].items()}
        mgr.save(2, state)
        with torch.no_grad():          # spoil the live state, then restore
            for p in state.params.values():
                p.add_(1.0)
            for m in state.opt_state["mu"].values():
                m.zero_()
        back = mgr.restore(state)
        out["restore_ok"] = back.step == 2 and all(
            torch.equal(back.params[n], before[n]) for n in before) and all(
            torch.equal(back.opt_state["mu"][n], mu[n]) for n in mu)
    if mesh.is_first:
        torch.save(out, f"{d}/{tag}.pt")


def serve(mesh, tag, kv8=False):
    model = VideoGLaMM(inp["cfg"], quant_kv_int8=kv8).eval()
    model.load_weights(inp["sd_serve"])
    shard_params(model, mesh)
    res = GroundedInference(model, max_new_tokens=inp["max_new"],
                            eos_id=inp["eos"])(*inp["request"])
    if mesh.is_first:
        torch.save(res._asdict(), f"{d}/{tag}.pt")


mesh = create_mesh(data=2, model=2)
json.dump([mesh.axis("data").index, mesh.axis("model").index],
          open(f"{d}/coords{rank}.json", "w"))
train(mesh, "2x2", inp["batch"])
lo = rank < 2
sub = create_mesh(data=2, model=1, ranks=[0, 1]) if lo else \
    create_mesh(data=1, model=2, ranks=[2, 3])
train(sub, "2x1" if lo else "1x2", inp["batch"], ckpt=True)
if lo:
    train(sub, "2x1_accum", inp["stacked"], grad_accum=2)
else:
    serve(sub, "serve_1x2")
    serve(sub, "serve_1x2_kv8", kv8=True)
if lo:
    serve(sub, "serve_2x1")
else:
    train(sub, "1x2_vocab", inp["batch"], cfg=inp["cfg_vocab"],
          sd=inp["sd_vocab"])
print(f"rank {rank} ok", flush=True)
"""


@pytest.fixture(scope="module")
def setup():
    jm = JVideoGLaMM(CFG, dtype=jnp.float32, lora_rank=LORA_RANK)
    batch = make_batch(np.random.RandomState(0), Bv=2, R=4)
    params = seeded_params(
        lambda: jm.init(jax.random.PRNGKey(0), **batch), 11)["params"]
    b2 = make_batch(np.random.RandomState(5), Bv=2, R=4)
    stacked = {k: np.stack([np.asarray(batch[k]), np.asarray(b2[k])])
               for k in batch}
    return dict(jm=jm, params=params, batch=batch,
                sd=videoglamm_state_dict(params, CFG),
                tbatch=_torch_batch(batch), tstacked=_torch_batch(stacked))


def _request(tbatch):
    v = tbatch["video_idx"]
    return (tbatch["frames"][v], tbatch["context_images"][v],
            tbatch["frames_sam"][v], tbatch["input_ids"], tbatch["text_lens"])


def _vocab_state_dict():
    torch.manual_seed(3)
    model = VideoGLaMM(_vocab_cfg(PCFG), lora_rank=LORA_RANK)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05)
    return model.state_dict()


@pytest.fixture(scope="module", autouse=True)
def group(setup, tmp_path_factory):
    """Start the four processes when the module starts; the tests that need
    no process, and the parent's references, run meanwhile.
    Yields the directory the ranks write to, once they have all ended."""
    d = tmp_path_factory.mktemp("group")
    sd_vocab = _vocab_state_dict()
    torch.save(dict(cfg=PCFG, tcfg=TCFG, sd=setup["sd"], batch=setup["tbatch"],
                    stacked=setup["tstacked"], cfg_vocab=_vocab_cfg(PCFG),
                    sd_vocab=sd_vocab,
                    sd_serve={k: v for k, v in setup["sd"].items()
                              if "lora_" not in k},
                    request=_request(setup["tbatch"]), max_new=MAX_NEW,
                    eos=EOS), d / "inputs.pt")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), addr,
                               str(d)], env=env, cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(4)]
    state = dict(dir=d, procs=procs, sd_vocab=sd_vocab, outs=None)
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()


def _results(group):
    if group["outs"] is None:
        outs = []
        for p in group["procs"]:
            try:
                outs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                for q in group["procs"]:
                    q.kill()
                pytest.fail(f"the process group did not end within "
                            f"{GROUP_TIMEOUT} s (a collective hung?)")
        group["outs"] = outs
    for r, (p, out) in enumerate(zip(group["procs"], group["outs"])):
        assert p.returncode == 0 and f"rank {r} ok" in out, \
            f"rank {r} failed:\n{out[-4000:]}"
    return group["dir"]


def _load(group, tag):
    return torch.load(_results(group) / f"{tag}.pt", weights_only=False)


@pytest.fixture(scope="module")
def one_process(setup, group):
    """The port's one-process step, two steps from the same weights:
    {case: (metrics, final parameters, first-step gradients)}."""
    def run(cfg, sd, batch, grad_accum):
        tr = build_training(cfg, dataclasses.replace(
            TCFG, grad_accum_steps=grad_accum), sd, device="cpu",
            dtype=torch.float32)
        state, metrics, first = tr.state, [], None
        for _ in range(2):
            state, m = tr.train_step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            if first is None:      # the first update has lr 0: mu = 0.1 g
                first = {n: m / (1.0 - TCFG.beta1)
                         for n, m in state.opt_state["mu"].items()}
        return metrics, {n: p.detach().clone()
                         for n, p in tr.model.named_parameters()}, first

    return {"plain": run(PCFG, setup["sd"], setup["tbatch"], 1),
            "accum": run(PCFG, setup["sd"], setup["tstacked"], 2),
            "vocab": run(_vocab_cfg(PCFG), group["sd_vocab"], setup["tbatch"], 1)}


def _hold(got_metrics, got_params, want, start, trainable, what, coarse=()):
    """coarse: leaves held at TOL_PARAM only."""
    metrics, params, first = want
    for i, (g, w) in enumerate(zip(got_metrics, metrics)):
        for k in METRICS:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{what} step {i} {k}")
    assert set(got_params) <= set(params)
    moved = 0
    for n, p in got_params.items():
        if n not in trainable:
            assert torch.equal(p, start[n]), f"{what}: frozen {n} changed"
            continue
        got, ref = p.numpy(), params[n].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_PARAM,
                                   err_msg=f"{what}: {n}")
        g = np.abs(first[n].numpy())
        clear = g > 0.1 * max(g.max(), 1e-30)
        if clear.any() and n not in coarse:
            np.testing.assert_allclose(got[clear], ref[clear], rtol=0,
                                       atol=TOL_CLEAR,
                                       err_msg=f"{what}: {n} (clear entries)")
        moved += int(not torch.equal(p, start[n]))
    assert moved > 10, what


def _trainable(cfg=PCFG):
    tr = build_training(cfg, TCFG, device="cpu", dtype=torch.float32)
    return set(tr.tx.trainable)


# ---------------------------------------------------------------- the mesh


def test_create_mesh_shapes_and_errors_match_jax():
    mesh = create_mesh()
    assert mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1} and mesh.ranks == (0,)
    assert mesh.axis(DATA_AXIS) == Axis(None, 1, 0) == mesh.axis(MODEL_AXIS)
    cases = [(dict(model=2), [0]), (dict(model=3), list(range(8))),
             (dict(data=3, model=2), list(range(8))),
             (dict(data=2, model=2), [0])]
    for kw, ranks in cases:
        with pytest.raises(AssertionError) as want:
            jcreate_mesh(devices=jax.devices()[:len(ranks)], **kw)
        with pytest.raises(ValueError) as got:
            create_mesh(ranks=ranks, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="model=2"):
        create_mesh(model=2)
    assert local_mesh().shape == mesh.shape
    # with_sharding: this rank's contiguous shard, or the tensor itself
    # where the split does not divide (JAX's fallback to replication)
    half = types.SimpleNamespace(shape=MESH2.shape,
                                 axis=lambda name: Axis(None, 2, 1))
    x = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(with_sharding(x, (None, MODEL_AXIS), half), x[:, 3:])
    assert with_sharding(x[:3], (MODEL_AXIS, None), half).shape == (3, 6)
    assert with_sharding(x, (), half) is x


# ------------------------------------------------------ the partition rules


def _jax_tree(cfg):
    jm = JVideoGLaMM(cfg, dtype=jnp.float32, lora_rank=LORA_RANK)
    b = make_batch(np.random.RandomState(0))
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), **b))["params"]


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _mapped(spec_tree, shapes, cfg):
    """JAX specs over the JAX tree -> {port name: (axis, port dim)}: each
    leaf is filled with +/-(1 + its index along the split dim (+ model,
    - data)) and carried through `videoglamm_state_dict`; the port dim is
    the one the values vary along (None: the JAX dim is a scan axis the
    port unstacks)."""
    def enc(spec, leaf):
        nd = len(leaf.shape)
        full = (None,) * (nd - len(tuple(spec))) + tuple(spec)
        out = np.zeros(leaf.shape, np.float32)
        for axis, sign in ((MODEL_AXIS, 1.0), (DATA_AXIS, -1.0)):
            if axis in full:
                j = full.index(axis)
                shp = [1] * nd
                shp[j] = leaf.shape[j]
                out = out + sign * np.broadcast_to(
                    (1 + np.arange(leaf.shape[j])).reshape(shp), leaf.shape)
        return out

    arrays = jax.tree_util.tree_map(enc, spec_tree, shapes, is_leaf=_is_spec)
    out = {}
    for n, t in videoglamm_state_dict(arrays, cfg).items():
        if not bool(t.abs().max() > 0):
            out[n] = (None, None)
            continue
        axis = MODEL_AXIS if bool(t.max() > 0) else DATA_AXIS
        dims = [d for d in range(t.ndim)
                if t.shape[d] > 1 and bool((t.diff(dim=d) != 0).any())]
        assert len(dims) <= 1, (n, dims)
        out[n] = (axis, dims[0] if dims else None)
    return out


def _port_kind(spec):
    for axis in (MODEL_AXIS, DATA_AXIS):
        if axis in spec:
            return axis, spec.index(axis)
    return None, None


@pytest.mark.parametrize("vocab", ["tiny", "vocab511"])
def test_param_partition_spec_matches_jax(vocab):
    """Every leaf: the rule table alone, and the specs made safe on a
    (2, 2) mesh (a split that does not divide replicates). With vocabulary
    511 + [SEG] the embedding and lm_head split; at 513 they replicate."""
    jcfg = CFG if vocab == "tiny" else _vocab_cfg(CFG)
    shapes = _jax_tree(jcfg)
    jraw = jparam_partition_spec(shapes)
    jsafe = jax.tree_util.tree_map(
        lambda s, v: s if jdivisible(v.shape, tuple(s), MESH2) else
        jax.sharding.PartitionSpec(), jraw, shapes, is_leaf=_is_spec)
    model = VideoGLaMM(port_config(jcfg), lora_rank=LORA_RANK)
    for jspec, mesh in ((jraw, None), (jsafe, MESH2)):
        want = _mapped(jspec, shapes, jcfg)
        got = param_partition_spec(model, mesh)
        assert set(got) <= set(want)
        for n in got:
            assert _port_kind(got[n]) == want[n], (n, mesh, got[n], want[n])
        split = {n for n, s in got.items() if s}
        assert any("qkv_proj" in n for n in split)
        emb = "llm.model.embed_tokens.weight"
        assert (emb in split) == (mesh is None or vocab == "vocab511")


def _dim0_in_port(shapes, cfg):
    """{port name: the port dim that JAX's dim 0 of the leaf became} (None
    where it is a scan axis that the port unstacks)."""
    def enc(leaf):
        shp = [1] * len(leaf.shape)
        if not shp:
            return np.zeros((), np.float32)
        shp[0] = leaf.shape[0]
        return np.broadcast_to((1 + np.arange(leaf.shape[0])).reshape(shp),
                               leaf.shape).astype(np.float32)

    out = {}
    for n, t in videoglamm_state_dict(jax.tree_util.tree_map(enc, shapes),
                                      cfg).items():
        dims = [d for d in range(t.ndim)
                if t.shape[d] > 1 and bool((t.diff(dim=d) != 0).any())]
        out[n] = dims[0] if dims else None
    return out


def test_opt_state_partition_spec_matches_jax():
    """The ZeRO-2 moment specs on a (2, 2) mesh against JAX's, leaf by
    leaf: the model axis always; the data axis (dim 0 where it divides)
    wherever the port's layout keeps JAX's dim 0 in place (biases, norms,
    embeddings, LoRA's B). Where it does not (a transposed Dense kernel,
    the scan axis of JAX's stacked layers) the port's dim 0 is another
    dim, and the port's rule is held on its own shapes."""
    shapes = _jax_tree(CFG)
    pspec = jparam_partition_spec(shapes)
    pspec = jax.tree_util.tree_map(
        lambda s, v: s if jdivisible(v.shape, tuple(s), MESH2) else
        jax.sharding.PartitionSpec(), pspec, shapes, is_leaf=_is_spec)
    tx = jmake_optimizer(JTCFG, shapes)
    ospec = jopt_state_partition_spec(jax.eval_shape(tx.init, shapes), pspec,
                                      MESH2)
    adam = [x for x in jax.tree_util.tree_leaves(
        ospec, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)][0]
    mu_spec = {jax.tree_util.keystr(kp): s for kp, s in
               jax.tree_util.tree_flatten_with_path(adam.mu, is_leaf=_is_spec)[0]}
    full = jax.tree_util.tree_map_with_path(
        lambda kp, v: mu_spec.get(jax.tree_util.keystr(kp),
                                  jax.sharding.PartitionSpec()), shapes)
    want = _mapped(full, shapes, CFG)
    dim0 = _dim0_in_port(shapes, CFG)

    model = VideoGLaMM(PCFG, lora_rank=LORA_RANK)
    tx_port = build_training(PCFG, TCFG, device="cpu", dtype=torch.float32).tx
    full_state = create_train_state(model, tx_port)
    got = opt_state_partition_spec(full_state.opt_state,
                                   param_partition_spec(model, MESH2), MESH2)
    assert got["count"] == () and got["mu"] == got["nu"]
    assert set(got["mu"]) == set(tx_port.trainable)
    same = moved = 0
    for n, spec in got["mu"].items():
        kind = _port_kind(spec)
        shape = tuple(full_state.opt_state["mu"][n].shape)
        if MODEL_AXIS in (kind[0], want[n][0]):
            assert kind == want[n], (n, kind, want[n])
            continue
        assert kind == ((DATA_AXIS, 0) if shape[0] % 2 == 0 else (None, None)), n
        if dim0[n] == 0:
            assert kind == want[n], (n, kind, want[n])
            same += 1
        else:
            moved += 1
    assert same >= 20 and moved > 0, (same, moved)


# ------------------------------------------------ the split of the losses


def test_split_losses_sum_to_the_one_process_loss(setup):
    """Each data rank's rows with the whole batch's divisors: the two
    ranks' losses add up to the one-process loss (1e-6 relative), each
    row stays with its video, and a batch whose videos do not divide runs
    whole on every rank."""
    model = VideoGLaMM(PCFG, lora_rank=LORA_RANK)
    model.load_state_dict(setup["sd"])
    batch = setup["tbatch"]
    with torch.no_grad():
        whole = model(**batch)
        parts = []
        for d in range(2):
            mesh = types.SimpleNamespace(axis=lambda name, d=d: Axis(None, 2, d))
            local = split_batch(batch, mesh)
            assert local["frames"].shape[0] == 1
            assert torch.equal(local["input_ids"], batch["input_ids"][d::2])
            assert torch.equal(local["video_idx"], torch.zeros(2, dtype=torch.long))
            parts.append(model(**local))
        one_video = {k: (v[:1] if k in ("frames", "context_images", "frames_sam")
                         else v) for k, v in batch.items()}
        one_video["video_idx"] = torch.zeros_like(batch["video_idx"])
        assert split_batch(one_video, mesh) is one_video
    for k in METRICS:
        got = sum(float(getattr(p, k)) for p in parts)
        np.testing.assert_allclose(got, float(getattr(whole, k)), rtol=1e-6,
                                   err_msg=k)


def test_sharded_step_on_one_rank_is_make_train_step_bit_for_bit(setup):
    """Mesh (1, 1): no collective is issued and three steps give
    `make_train_step`'s parameters, moments and metrics bit for bit (the
    same model runs both, so the CPU's vector code sees the same
    alignments)."""
    tcfg = dataclasses.replace(TCFG, grad_accum_steps=1)
    tr = build_training(PCFG, tcfg, setup["sd"], device="cpu",
                        dtype=torch.float32)
    start = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    state, want = tr.state, []
    for _ in range(3):
        state, m = tr.train_step(state, setup["tbatch"])
        want.append(m)
    end = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    mu = {n: m.clone() for n, m in state.opt_state["mu"].items()}
    with torch.no_grad():
        for n, p in tr.model.named_parameters():
            p.copy_(start[n])
    step, sstate, split = make_sharded_train_step(
        tr.model, tr.tx, create_mesh(), create_train_state(tr.model, tr.tx))
    assert split(setup["tbatch"]) is setup["tbatch"]
    for i in range(3):
        sstate, m = step(sstate, setup["tbatch"])
        assert all(torch.equal(m[k], want[i][k]) for k in METRICS), i
    assert sstate.step == 3 and sstate.opt_state["count"] == 3
    for n, p in tr.model.named_parameters():
        assert torch.equal(p, end[n]), n
    assert all(torch.equal(sstate.opt_state["mu"][n], mu[n]) for n in mu)


# ------------------------------------------------- the group's sharded runs


def test_mesh_coordinates_over_four_ranks(group):
    import json
    d = _results(group)
    for r in range(4):
        assert json.load(open(d / f"coords{r}.json")) == [r // 2, r % 2]


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
def test_sharded_step_matches_one_process(setup, group, one_process, mesh):
    res = _load(group, mesh)
    assert res["split"] == mesh.startswith("2")
    assert (res["n_model_split"] > 0) == mesh.endswith("x2")
    if mesh == "2x1":
        assert res["n_data_split"] > 10        # ZeRO-2 moments
    _hold(res["metrics"], res["params"], one_process["plain"], setup["sd"],
          _trainable(), f"mesh {mesh}")


# JAX's GSPMD step on the (2, 2) mesh moves the mask decoder's two
# ConvTranspose kernels by up to 2e-3 (Adam sign flips on 7 of 423 entries
# with a clear first gradient) from its own one-device step on this batch,
# while the port's one-process step agrees with that one-device step to
# 3e-7 there; the port's (2, 2) step is held to its one-process step on
# them at TOL_CLEAR (test_sharded_step_matches_one_process), and to JAX's
# sharded step at TOL_PARAM.
JAX_SHARDED_CONV_T = ("visual_model.sam_mask_decoder.output_upscaling.0.weight",
                      "visual_model.sam_mask_decoder.output_upscaling.3.weight")


def test_sharded_step_2x2_matches_jax(setup, group, one_process):
    """The port's (2, 2) step against JAX's `make_sharded_train_step` on
    the same mesh over four virtual CPU devices (XLA attention)."""
    jm = setup["jm"]
    tx = jmake_optimizer(JTCFG, setup["params"])
    mesh = jcreate_mesh(data=2, model=2, devices=jax.devices()[:4])
    step, state, bsh = jsharded_step(jm, tx, mesh,
                                     jcreate_state(setup["params"], tx),
                                     setup["batch"])
    batch = jax.tree_util.tree_map(jax.device_put, setup["batch"], bsh)
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    want = videoglamm_state_dict(jax.tree_util.tree_map(np.asarray,
                                                        state.params), CFG)
    res = _load(group, "2x2")
    _hold(res["metrics"], res["params"], (metrics, want,
                                          one_process["plain"][2]),
          setup["sd"], _trainable(), "mesh 2x2 against JAX",
          coarse=JAX_SHARDED_CONV_T)


def test_grad_accum_sharded_matches_one_process(setup, group, one_process):
    """grad_accum=2 at (2, 1): each micro-step split by videos."""
    res = _load(group, "2x1_accum")
    assert res["split"]
    _hold(res["metrics"], res["params"], one_process["accum"], setup["sd"],
          _trainable(), "mesh 2x1, grad_accum 2")


def test_vocab_parallel_step_matches_one_process(group, one_process):
    """Vocabulary 512 at (1, 2): embed_tokens and lm_head split by rows."""
    res = _load(group, "1x2_vocab")
    sd = group["sd_vocab"]
    start = {n: sd[n] for n in res["params"]}
    _hold(res["metrics"], res["params"], one_process["vocab"], start,
          _trainable(_vocab_cfg(PCFG)), "mesh 1x2, vocab 512")


def test_two_rank_checkpoint_restores_in_one_process(setup, group):
    """The (2, 1) run's checkpoint (ZeRO-2 moments gathered over data) and
    the (1, 2) run's (tensor-parallel weights gathered over model), each
    written whole by its mesh's first rank, restore into a one-process
    state; each rank also restored its own checkpoint into its shards."""
    for tag in ("2x1", "1x2"):
        res = _load(group, tag)
        assert res["restore_ok"], tag
        tr = build_training(PCFG, TCFG, setup["sd"], device="cpu",
                            dtype=torch.float32)
        back = CheckpointManager(str(group["dir"] / f"ckpt_{tag}")).restore(
            tr.state)
        assert back.step == 2 and back.opt_state["count"] == 2
        for n, p in back.params.items():
            assert torch.equal(p, res["params"][n]), (tag, n)
        assert sum(bool(m.abs().max() > 0)
                   for m in back.opt_state["mu"].values()) > 10


@pytest.mark.parametrize("mesh", ["1x2", "2x1", "1x2_kv8"])
def test_serving_over_a_mesh_gives_the_unsharded_tokens(setup, group, mesh):
    """Tokens, lengths and [SEG] slots equal to the unsharded run's, masks
    within 1e-4; over `model` the cache (float, or int8 read by K4's twin)
    holds a rank's heads."""
    model = VideoGLaMM(PCFG, quant_kv_int8=mesh.endswith("kv8")).eval()
    model.load_weights({k: v for k, v in setup["sd"].items()
                        if "lora_" not in k})
    want = GroundedInference(model, max_new_tokens=MAX_NEW, eos_id=EOS)(
        *_request(setup["tbatch"]))
    got = _load(group, f"serve_{mesh}")
    assert torch.equal(got["tokens"], want.tokens)
    assert torch.equal(got["lengths"], want.lengths)
    assert torch.equal(got["seg_valid"], want.seg_valid)
    torch.testing.assert_close(got["pred_masks"], want.pred_masks, rtol=0,
                               atol=1e-4)


def test_shard_params_refuses_a_quantised_llm_and_llama_over_model():
    """Over a model axis of 2 (before any collective): an int8 LLM and the
    Llama base raise NotImplementedError naming their ROADMAP item; over
    `data` alone nothing is split."""
    from videoglamm_torch.config import LlamaConfig
    from videoglamm_torch.parallel import shard_params

    def mesh(model):
        axes = {DATA_AXIS: Axis(None, 1, 0), MODEL_AXIS: Axis(None, model, 0)}
        return types.SimpleNamespace(shape={DATA_AXIS: 1, MODEL_AXIS: model},
                                     axis=axes.__getitem__)

    quant = VideoGLaMM(PCFG, quant_llm_int8=True)
    with pytest.raises(NotImplementedError, match="item 9"):
        shard_params(quant, mesh(2))
    assert shard_params(quant, mesh(1)) == {} and quant.mesh.shape[MODEL_AXIS] == 1
    llama = VideoGLaMM(dataclasses.replace(PCFG, llm_type="llama3_1",
                                           llama=LlamaConfig.tiny()))
    with pytest.raises(NotImplementedError, match="Llama over the model axis"):
        shard_params(llama, mesh(2))
