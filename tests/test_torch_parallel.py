"""The port's parallel layer (fft_tpu_torch/parallel/) against the JAX
package's on its 8-fake-device mesh: the causal mix sequence parallel over
4 ranks (tests/test_causal_segmented.py's case, seq 64 at chunk 8, with
mean pooling and memory, DCT and attention pooling), the sliding window's
halo exchange at 2 and 4 ranks, GPipe at (stages, layers, microbatches) =
(2, 4, 2) and (4, 4, 4) (tests/test_pipeline.py), a non-causal block
with the wavelet head parallel over 2 ranks, a tiny LM's train step
(2 layers, d=64, seq 256) under the (data, seq, model) meshes (2, 1, 1),
(1, 2, 2) and (1, 4, 1), the sharding rule against JAX's ``_spec_for``,
and every collective at world size 1.

The port's ranks run over gloo in spawned processes
(tests/torch_parallel_worker.py), one spawn per world size.  Tolerances
(tests/golden_utils.py's rel_err): 2e-5 forward (JAX's own sharded
tests), 1e-4 for logits, losses and every gradient.  A gradient that is
zero in exact arithmetic (the attention scorer's output bias: a shift of
every score leaves the softmax as it is) is held against the largest
gradient of its module instead of its own rounding noise."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fft_tpu.config as jcfg
import fft_tpu.layers.attention as jattn
import fft_tpu.models.hybrid as jhy
import fft_tpu.models.lm as jlm
import fft_tpu.parallel.mesh as jmesh
import fft_tpu.train as jtrain
from fft_tpu.layers import spectre_block_apply
from fft_tpu.parallel import make_mesh as jax_mesh
from fft_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.convert import (
    block_from_jax_params, block_to_jax_params, from_jax_params,
    hybrid_from_jax_params,
)
from fft_tpu_torch.layers import attention as tattn
from fft_tpu_torch.layers.causal_seg import (
    segmented_causal_mix, sp_segmented_causal_mix,
)
from fft_tpu_torch.layers.spectre import spectre_block_init as port_block
from fft_tpu_torch.models import hybrid as thy
from fft_tpu_torch.models import lm as tlm
from fft_tpu_torch.parallel import comm, make_mesh, make_stage_mesh
from fft_tpu_torch.parallel.mesh import model_shard_dim
from fft_tpu_torch.parallel.pipeline import pipeline_apply
from tests import torch_parallel_worker as worker
from tests.golden_utils import rel_err
from tests.test_torch_convert import jax_lm_config, lm_pair
from tests.test_torch_dist_fft import _jax_block, jit_run

FWD_TOL = 2e-5
TOL = 1e-4
POOLERS = [("mean", 8), ("dct", 0), ("attention", 0)]
CP_CASES = {2: (2, 64, 2, 8, 8), 4: (2, 64, 2, 8, 8)}   # B, N, H, hd, W
PP_CASES = {2: [(4, 2, 16, True)],      # layers, micro, n_fft, grads
            4: [(4, 4, 32, False)]}
LM_LAYOUTS = {2: [(2, 1, 1)], 4: [(1, 2, 2), (1, 4, 1)]}


def _grad_err(got, want, floor):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))
                 / max(np.max(np.abs(np.asarray(want))), floor))


def _jcfg(cfg):
    return jcfg.SpectreConfig(**dataclasses.asdict(cfg))


def _causal_cfg(pool, memory):
    return SpectreConfig(embed_dim=32, num_heads=4, n_fft=64,
                         pooling_type=pool, wavelet_on_rate=0.0, causal=True,
                         causal_chunk=8, causal_impl="segmented",
                         fft_impl="matmul", memory_size=memory)


def _port_params(cfg, seed):
    """(JAX block params, the port's state_dict) of one block drawn by the
    port's init (faster here than JAX's eager one)."""
    sd = port_block(cfg, torch.Generator().manual_seed(seed),
                    "cpu").state_dict()
    return block_to_jax_params(sd, cfg), sd


def _block_case(cfg, seed, n, d=32):
    rng = np.random.default_rng(seed)
    params, _ = _port_params(cfg, seed)
    return dict(cfg=cfg, params=params,
                x=rng.standard_normal((2, n, d)).astype(np.float32),
                w=rng.standard_normal((2, n, d)).astype(np.float32))


def _lm_cfg():
    return tlm.LMConfig(
        vocab_size=64, num_layers=2, max_seq=256,
        block=SpectreConfig(embed_dim=64, num_heads=4, n_fft=256,
                            pooling_type="mean", wavelet_on_rate=0.0,
                            causal=True, causal_chunk=32,
                            causal_impl="segmented"))


def _pp_case(layers, n, seed):
    cfg = SpectreConfig(embed_dim=32, num_heads=4, n_fft=n,
                        pooling_type="mean", wavelet_on_rate=0.0,
                        fft_impl="matmul")
    trees = [_port_params(cfg, seed + j)[0] for j in range(layers)]
    params = jax.tree.map(lambda *a: np.stack(a), *trees)
    x = np.random.default_rng(seed).standard_normal((4, n, 32)).astype(
        np.float32)
    return cfg, params, x


def _jax_cp(c, world):
    mesh = jax_mesh(data=1, seq=world, model=1)

    def loss(q, k, v):
        y = jattn.sliding_window_attention_cp(q, k, v, c["window"], mesh)
        return jnp.sum(y * c["w"]), y

    (_, y), grads = jit_run(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True), c["q"], c["k"], c["v"])
    return np.asarray(y), [np.asarray(g) for g in grads]


def _jax_pp(c, world):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:world]), ("stage",))
    jc = _jcfg(c["cfg"])

    def loss(params):
        y = jax_pipeline(params, lambda p, h: spectre_block_apply(p, jc, h),
                         c["x"], mesh=mesh, num_microbatches=c["micro"])
        return jnp.sum(y ** 2), y

    (_, y), gp = jit_run(jax.value_and_grad(loss, has_aux=True),
                         c["params"])
    return np.asarray(y), jax.tree.map(np.asarray, gp)


def _jax_block_plain(c):
    """JAX's block on one device: (y, grads of the parameters, dL/dx) of
    sum(y * w)."""
    jc = _jcfg(c["cfg"])

    def loss(params, x):
        y = spectre_block_apply(params, jc, x)
        return jnp.sum(y * c["w"]), y

    (_, y), (gp, gx) = jit_run(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True), c["params"], c["x"])
    return np.asarray(y), jax.tree.map(np.asarray, gp), np.asarray(gx)


def _jax_lm_step(lm, layout):
    """JAX's train-step loss and gradients (the value_and_grad of the loss
    its train_step differentiates) on make_mesh(*layout), and optax's
    global norm of them (its train_step's grad_norm)."""
    jc = jax_lm_config(lm["cfg"])
    mesh = jax_mesh(*layout)
    params = jax.tree.map(jnp.asarray, lm["params"])
    loss, grads = jit_run(
        jax.value_and_grad(lambda p, b: jtrain.lm_loss(p, jc, b, mesh=mesh)),
        params, lm["batch"].astype(np.int32),
        in_shardings=(jmesh.lm_param_shardings(mesh, params),
                      jmesh.lm_batch_sharding(mesh)))
    return float(loss), float(optax.global_norm(grads)), \
        jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world size's ranks, spawned once for every case of the module
    (both spawns run while JAX computes the references), the inputs and
    JAX's results."""
    lm_cfg = _lm_cfg()
    lm_params, _ = lm_pair(lm_cfg, seed=3)
    batch = np.random.default_rng(3).integers(
        0, lm_cfg.vocab_size, (4, lm_cfg.max_seq + 1)).astype(np.int64)
    lm = dict(cfg=lm_cfg, params=lm_params, batch=batch)
    out, spawned = {"lm": lm}, {}
    for world in (2, 4):
        payloads, inputs = {}, {}
        if world == 4:
            cases = [_block_case(_causal_cfg(pool, mem), 20 + i, 64)
                     for i, (pool, mem) in enumerate(POOLERS)]
            payloads["causal"] = {"cases": [dict(
                cfg=dataclasses.replace(c["cfg"], fft_impl="auto"),
                sd=block_from_jax_params(c["params"], c["cfg"]),
                x=c["x"], w=c["w"]) for c in cases]}
            inputs["causal"] = cases
        b, n, h, hd, w = CP_CASES[world]
        rng = np.random.default_rng(world)
        cp = {k: rng.standard_normal((b, n, h, hd)).astype(np.float32)
              for k in ("q", "k", "v", "w")}
        cp["window"] = w
        payloads["cp"] = {"cases": [cp]}
        inputs["cp"] = cp
        pp = []
        for i, (layers, micro, n_fft, grads) in enumerate(PP_CASES[world]):
            cfg, params, x = _pp_case(layers, n_fft, 30 + i)
            pp.append(dict(cfg=cfg, params=params, x=x, micro=micro,
                           grads=grads, sds=[block_from_jax_params(
                               params, cfg, layer=j) for j in range(layers)]))
        payloads["pp"] = {"cases": [{k: c[k] for k in (
            "cfg", "sds", "x", "micro", "grads")} for c in pp]}
        inputs["pp"] = pp
        if world == 2:
            c = _block_case(SpectreConfig(
                embed_dim=32, num_heads=4, n_fft=64, pooling_type="mean",
                wavelet_on_rate=1.0, memory_size=8, fft_impl="matmul"),
                40, 64)
            payloads["tp_block"] = dict(
                cfg=dataclasses.replace(c["cfg"], fft_impl="auto"),
                sd=block_from_jax_params(c["params"], c["cfg"]), x=c["x"],
                w=c["w"])
            inputs["tp_block"] = c
        payloads["lm_step"] = dict(
            cfg=lm_cfg, sd=from_jax_params(lm_params, lm_cfg), batch=batch,
            layouts=LM_LAYOUTS[world])
        spawned[world] = worker.start(world, payloads,
                                      tmp_path_factory.mktemp("par"))
        out[world] = dict(inputs=inputs)
    # JAX's references, a few at a time (XLA compiles outside the GIL)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for world, o in out.items():
            if world == "lm":
                continue
            ins = o["inputs"]
            o["jax"] = dict(
                causal=[pool.submit(_jax_block, c["cfg"], c["params"],
                                    c["x"], c["w"], "contiguous")
                        for c in ins.get("causal", [])],
                cp=pool.submit(_jax_cp, ins["cp"], world),
                pp=[pool.submit(_jax_pp, c, world) for c in ins["pp"]],
                tp_block=(pool.submit(_jax_block_plain, ins["tp_block"])
                          if "tp_block" in ins else None),
                lm={layout: pool.submit(_jax_lm_step, lm, layout)
                    for layout in LM_LAYOUTS[world]})
    for world, o in out.items():
        if world != "lm":
            j = o["jax"]
            j["causal"] = [f.result() for f in j["causal"]]
            j["cp"] = j["cp"].result()
            j["pp"] = [f.result() for f in j["pp"]]
            j["tp_block"] = j["tp_block"] and j["tp_block"].result()
            j["lm"] = {k: f.result() for k, f in j["lm"].items()}
    for world, r in spawned.items():
        out[world]["ranks"] = r.results()
    return out


@pytest.mark.parametrize("index", range(len(POOLERS)))
def test_causal_sp_matches_jax(runs, index):
    """A causal block at seq 64, chunk 8, over 4 ranks (two chunks each):
    output, dL/dx and every parameter's gradient (summed over the ranks)
    against JAX's block on the sequence-sharded mesh."""
    c = runs[4]["inputs"]["causal"][index]
    got = [r["causal"][index] for r in runs[4]["ranks"]]
    y, gp, gx = runs[4]["jax"]["causal"][index]
    assert rel_err(np.concatenate([g["y"] for g in got], axis=1),
                   y) < FWD_TOL
    assert rel_err(np.concatenate([g["x_grad"] for g in got], axis=1),
                   gx) < TOL
    want = block_from_jax_params(gp, c["cfg"])
    floor = max(float(t.abs().max()) for t in want.values())
    for name, ref in want.items():
        if name == "memory_fft":
            continue
        total = sum(np.asarray(g["grads"][name]) for g in got)
        assert _grad_err(total, ref, 1e-3 * floor) < TOL, name


@pytest.mark.parametrize("world", [2, 4])
def test_sliding_window_attention_cp_matches_jax(runs, world):
    """The halo exchange: output and the cotangents of q, k and v."""
    y, grads = runs[world]["jax"]["cp"]
    got = [r["cp"][0] for r in runs[world]["ranks"]]
    assert rel_err(np.concatenate([g["y"] for g in got], axis=1),
                   y) < FWD_TOL
    for i, ref in enumerate(grads):
        assert rel_err(np.concatenate([g["grads"][i] for g in got], axis=1),
                       ref) < TOL


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_matches_jax(runs, world):
    """GPipe's output on every stage at (stages, layers, microbatches) =
    (2, 4, 2) and (4, 4, 4) and, at (2, 4, 2), each stage's blocks'
    gradients of sum(y^2), against JAX's pipeline_apply."""
    c = runs[world]["inputs"]["pp"][0]
    y, gp = runs[world]["jax"]["pp"][0]
    got = [r["pp"][0] for r in runs[world]["ranks"]]
    for g in got:
        assert rel_err(g["y"], y) < FWD_TOL
    if not c["grads"]:
        return
    per = len(c["sds"]) // world
    for stage, g in enumerate(got):
        for j, grads in enumerate(g["grads"]):
            want = block_from_jax_params(gp, c["cfg"], layer=stage * per + j)
            for name, ref in want.items():
                assert rel_err(grads[name], ref.numpy()) < TOL, name


def test_head_parallel_block_matches_jax(runs):
    """A non-causal block with memory and the wavelet on (rate 1: its gate
    from the gathered descriptor) head parallel over 2 ranks: output,
    dL/dx and every gradient gathered, against JAX's block."""
    c = runs[2]["inputs"]["tp_block"]
    y, gp, gx = runs[2]["jax"]["tp_block"]
    got = [r["tp_block"] for r in runs[2]["ranks"]]
    want = block_from_jax_params(gp, c["cfg"])
    for g in got:
        assert rel_err(g["y"], y) < FWD_TOL
        assert rel_err(g["x_grad"], gx) < TOL
        for name, ref in want.items():
            if name != "memory_fft":
                assert rel_err(g["grads"][name], ref.numpy()) < TOL, name


@pytest.mark.parametrize("world,layout", [(2, (2, 1, 1)), (4, (1, 2, 2)),
                                          (4, (1, 4, 1))])
def test_lm_train_step_matches_jax(runs, world, layout):
    """The loss, the unclipped global norm and every gradient (gathered
    into the single-device layout) of one train_step of the sharded LM,
    the same on every rank."""
    loss, gnorm, grads = runs[world]["jax"]["lm"][layout]
    got = runs[world]["ranks"][0]["lm_step"][layout]
    for r in runs[world]["ranks"][1:]:
        assert r["lm_step"][layout]["loss"] == got["loss"]
        assert r["lm_step"][layout]["grad_norm"] == got["grad_norm"]
    assert abs(got["loss"] - loss) < TOL * abs(loss)
    assert abs(got["grad_norm"] - gnorm) < TOL * gnorm
    want = from_jax_params(grads, runs["lm"]["cfg"])
    assert sorted(want) == sorted(got["grads"])
    for name, ref in want.items():
        assert got["grads"][name].shape == ref.shape, name
        assert rel_err(got["grads"][name], ref.numpy()) < TOL, name


def _tagged(tree):
    """Each leaf of a JAX tree filled with its index along the axis JAX's
    ``_spec_for`` shards on 'model' (zeros where it replicates).  The
    hybrid's SPECTRE leaves are stacked (G, S, ...), where the rule,
    written for one stack axis, would land on S: they are tagged as
    leaves stacked once (over G * S layers), the LM's layout."""
    def tag(path, leaf):
        keys = jmesh._path_keys(path)
        extra = 1 if keys[0] == "spectre" else 0
        nd = len(leaf.shape)
        spec = tuple(jmesh._spec_for(keys, nd - extra))
        out = np.zeros(leaf.shape, np.float32)
        if "model" in spec:
            ax = spec.index("model") + extra
            shape = [1] * nd
            shape[ax] = leaf.shape[ax]
            out = out + np.arange(leaf.shape[ax], dtype=np.float32).reshape(
                shape)
        return out
    return jax.tree_util.tree_map_with_path(tag, tree)


def _varying_dims(t: torch.Tensor) -> list:
    return [d for d in range(t.dim())
            if not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]


@pytest.mark.parametrize("model", ["tiny", "350m", "hybrid"])
def test_sharding_rule_matches_jax_spec_for(model):
    """model_shard_dim on every state_dict key against JAX's _spec_for on
    the matching leaf, through the weight bridge (which transposes the
    linear weights).  The 350M: every key of a block, at 1 layer and a
    512-token vocab (the names are its 24 layers')."""
    if model == "hybrid":
        cfg = thy.hybrid_tiny_config(seq=256)
        tree = jax.eval_shape(lambda: jhy.hybrid_init(
            jax.random.key(0), jhy.hybrid_tiny_config(seq=256)))
        sd = hybrid_from_jax_params(_tagged(tree), cfg)
    else:
        cfg = (tlm.tiny_lm_config() if model == "tiny"
               else dataclasses.replace(tlm.spectre_350m_config(
                   vocab_size=512, seq=2048), num_layers=1))
        tree = jax.eval_shape(lambda: jlm.lm_init(jax.random.key(0),
                                                  jax_lm_config(cfg)))
        sd = from_jax_params(_tagged(tree), cfg)
    sharded = 0
    for key, t in sd.items():
        dims = _varying_dims(t)
        assert len(dims) <= 1, key
        assert model_shard_dim(key) == (dims[0] if dims else None), key
        sharded += bool(dims)
    assert sharded >= 5


def test_every_collective_at_world_size_one(tmp_path):
    """A 1-rank gloo group: each function of parallel/comm.py launches its
    collective (its counter moves) and gives the no-mesh value and
    cotangent bit for bit; the causal mix sequence parallel, the sliding
    window's halo exchange and a 1-stage pipeline equal their no-mesh
    paths bit for bit."""
    with worker.one_rank_group(tmp_path):
        mesh = make_mesh(1, 1, 1, device="cpu")
        stages = make_stage_mesh(1, device="cpu")
        comm.reset_calls()
        g = torch.Generator().manual_seed(0)
        x = torch.randn(2, 4, 6, generator=g)
        xc = torch.complex(x, torch.randn(2, 4, 6, generator=g))
        ct = torch.randn(2, 4, 6, generator=g)
        zero = torch.zeros_like(x)
        for fn, value, cot in (
                (lambda t: comm.all_to_all(t, mesh, "seq", 1, 2), x, ct),
                (lambda t: comm.all_gather(t, mesh, "seq", 1), x, ct),
                (lambda t: comm.gather_from(t, mesh, "model", -1), x, ct),
                (lambda t: comm.all_reduce(t, mesh, "data"), x, ct),
                (lambda t: comm.copy_to(t, mesh, "model"), x, ct),
                (lambda t: comm.reduce_from(t, mesh, "model"), x, ct),
                (lambda t: comm.halo_right(t, mesh, "seq"), zero, zero)):
            for inp in (x, xc):
                leaf = inp.clone().requires_grad_()
                y = fn(leaf)
                want = value if inp is x else (
                    torch.zeros_like(xc) if value is zero else xc)
                assert torch.equal(y, want)
                y.backward(ct if inp is x else torch.complex(ct, ct))
                assert torch.equal(leaf.grad, cot if inp is x else (
                    torch.zeros_like(xc) if cot is zero
                    else torch.complex(ct, ct)))
        assert torch.equal(comm.all_reduce_max(x, mesh, "model"), x)
        assert torch.equal(comm.stage_send_recv(x, stages, "stage"), x)
        assert torch.equal(comm.broadcast(x, stages, "stage", 0), x)
        flat = [x.clone(), xc.real.clone()]
        comm.sum_(flat, mesh, "seq")
        assert torch.equal(flat[0], x)

        # the causal mix: [v_{c0-1} | 0] is zero and no chunk is remote
        cfg = _causal_cfg("mean", 0)
        hc = cfg.head_config()
        v = torch.randn(2, 64, 32, generator=g, requires_grad=True)
        gate = torch.complex(*torch.randn(2, 2, 8, 4, 33, generator=g)
                             ).requires_grad_()
        ref = segmented_causal_mix(v, gate, hc, 8)
        ref.backward(torch.ones_like(ref))
        rv, rg = v.grad.clone(), gate.grad.clone()
        v.grad = gate.grad = None
        y = sp_segmented_causal_mix(v, gate, hc, 8, mesh)
        y.backward(torch.ones_like(y))
        assert torch.equal(y, ref) and torch.equal(v.grad, rv)
        assert torch.equal(gate.grad, rg)

        q, k, vv = torch.randn(3, 2, 32, 2, 8, generator=g)
        assert torch.equal(
            tattn.sliding_window_attention_cp(q, k, vv, 8, mesh),
            tattn.sliding_window_attention(q, k, vv, 8))

        cfg = SpectreConfig(embed_dim=32, num_heads=4, n_fft=16,
                            pooling_type="mean", wavelet_on_rate=0.0)
        blocks = [port_block(cfg, g, "cpu") for _ in range(2)]
        h = torch.randn(2, 16, 32, generator=g)
        plain = blocks[1](blocks[0](h))
        piped = pipeline_apply(blocks, lambda b, t: b(t), h, mesh=stages,
                               num_microbatches=1)
        assert torch.equal(piped, plain)
        assert all(comm.CALLS[k] > 0 for k in comm.KINDS), dict(comm.CALLS)
