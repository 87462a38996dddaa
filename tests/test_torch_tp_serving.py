"""Tensor-parallel paged serving of the port against the JAX package: gloo
ranks (one process each, spawned with torch.multiprocessing through
lws_tpu_torch.parallel.launch, bootstrapped from the env contract) run the
port's `PagedBatchEngine(mesh=...)` on JAX's weights landed as each rank's
shard (`params_from_jax(..., mesh=...)`). Rank 0's greedy tokens must equal
both JAX's engine on the same mesh shape (the 8-device virtual CPU mesh of
tests/conftest.py) and JAX's single-device engine, token for token; every
rank's tokens must be identical; every rank's shards must equal JAX's
NamedSharding shards of the same tp index, in shape (`shard_shape`) and
value; each rank's pool holds Hkv/tp heads. f32 tiny configs throughout.

The cases mirror tests/test_serving_paged_tp.py (kv_quant off and on, a
(dp=2, tp=2) mesh, indivisible heads refused) and
tests/test_moe_serving.py:96 (expert parallelism), plus int8 weights with
int8 KV at tp = 2, and the serving modes under a tp = 2 mesh:
tests/test_prefix_cache.py:167 (the prefix cache's hits),
tests/test_chunked_admission.py:145 (chunked admission with interleaved
decode steps) and tests/test_paged_speculative.py:95 (device-resident
speculation), each against JAX's single-device engine without the mode.
The JAX-only cases have no counterpart here:
  * test_paged_tp_kernel_interpret_matches: the port's CPU path runs each
    kernel's plain version, and the kernels are held to their plain
    versions on the card (chip_smoke.py, tests/test_torch_kernels_gpu.py);
  * test_kernel_failure_falls_back_to_xla: the port has no fallback, by
    rule: a CUDA tensor reaches its kernel or raises.
The dense Engine's cases are in tests/test_torch_tp_dense.py.

Each world size is one spawn whose members run every case of that world in
order (the cases' process groups are created in the same order on every
rank); the tests then read the results. The members' functions live at
this module's top level and import only the port.
"""

import os
import pickle

import numpy as np
import pytest

from lws_tpu_torch.parallel import launch

PROMPTS = [np.array([5, 9, 2], np.int32), np.array([7, 7, 1, 4, 11, 3], np.int32),
           np.array([3, 30, 60], np.int32)]


# ---------------------------------------------------------------------------
# Member side (port only)


def _params(case, mesh=None):
    from lws_tpu_torch.models.convert import params_from_jax

    return params_from_jax(case["tree"], case["cfg"], "cpu", mesh=mesh)


def _shards(model) -> dict:
    return {n: t.numpy().copy() for n, t in list(model.named_parameters())
            + list(model.named_buffers())}


def run_paged(case, mesh) -> dict:
    """PagedBatchEngine(mesh=...) serves case["prompts"] (optionally two
    step_n steps after each submit, as tests/test_moe_serving.py does)."""
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    engine = PagedBatchEngine(case["cfg"], _params(case, mesh), mesh=mesh, device="cpu",
                              **case["engine"])
    rids = []
    for p in case["prompts"]:
        rids.append(engine.submit(p, max_new_tokens=case["max_new"]))
        if case.get("step_n"):
            engine.step_n(2)
    assert all(r is not None for r in rids)
    engine.run_until_drained()
    c = engine.cache
    return {"tokens": [engine.result(r) for r in rids],
            "pool": [tuple(t.shape) for t in (c.k, c.v, c.k_scale, c.v_scale) if t is not None],
            "shards": _shards(engine.params) if case.get("shards") else None}


def run_refused(case, mesh) -> str:
    """The engine named by case["engine_cls"] on full weights and `mesh`
    must refuse; returns the message."""
    from lws_tpu_torch.serving.engine import Engine
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    cls = {"paged": PagedBatchEngine, "dense": Engine}[case["engine_cls"]]
    try:
        cls(case["cfg"], _params(case), mesh=mesh, device="cpu", **case["engine"])
    except ValueError as e:
        return str(e)
    raise AssertionError(f"{case['name']}: the engine accepted tp={mesh.tp}")


def run_mode(case, mesh) -> dict:
    """A serving mode (prefix cache, chunked admission, speculation) of
    PagedBatchEngine(mesh=...): case["prompts"] with case["max_new"] tokens
    each, `step_n` steps after each submit, then drained plainly or
    speculatively (case["spec"] = (gamma, ngram))."""
    from lws_tpu_torch.serving.paged_engine import PagedBatchEngine

    engine = PagedBatchEngine(case["cfg"], _params(case, mesh), mesh=mesh, device="cpu",
                              **case["engine"])
    rids = []
    for p, n in zip(case["prompts"], case["max_new"]):
        rids.append(engine.submit(p, max_new_tokens=n))
        if case.get("step_n"):
            engine.step_n(case["step_n"])
    assert all(r is not None for r in rids)
    if case.get("spec"):
        gamma, ngram = case["spec"]
        engine.run_until_drained_speculative(gamma=gamma, ngram=ngram)
    else:
        engine.run_until_drained()
    return {"tokens": [engine.result(r) for r in rids], "stats": dict(engine.stats),
            "stats_prefix": dict(engine.stats_prefix)}


RUNNERS = {"paged": run_paged, "refused": run_refused, "mode": run_mode}


def member(rank: int, cases: list, out_dir: str, runners_module: str) -> None:
    """One gloo rank: bootstrap from the env contract, then every case on
    its own mesh; results pickled to out_dir/<rank>.pkl."""
    import importlib

    import torch.distributed as dist

    from lws_tpu_torch.parallel import MeshSpec, build_mesh, initialize_from_env

    runners = importlib.import_module(runners_module).RUNNERS
    initialize_from_env(device="cpu")
    out = {}
    for case in cases:
        mesh = build_mesh(MeshSpec(dp=case["dp"], tp=case["tp"]))
        out[case["name"]] = runners[case["run"]](case, mesh)
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def spawn_cases(world: int, cases: list, out_dir, runners_module: str) -> list[dict]:
    """Run `cases` on `world` spawned gloo ranks; returns each rank's results."""
    ctx, _ = launch.spawn_group(member, world, args=(cases, str(out_dir), runners_module))
    launch.join(ctx, timeout_s=240)
    return [pickle.loads((out_dir / f"{r}.pkl").read_bytes()) for r in range(world)]


# ---------------------------------------------------------------------------
# JAX side


def port_tree(jparams):
    """JAX's tree as numpy, QuantizedArray leaves as the port's (picklable
    without JAX in the members)."""
    import jax

    from lws_tpu.models.quant import QuantizedArray as JaxQA
    from lws_tpu_torch.models.quant import QuantizedArray

    def leaf(x):
        if isinstance(x, JaxQA):
            return QuantizedArray(q=np.asarray(x.q), scale=np.asarray(x.scale))
        return np.asarray(x)

    return jax.tree.map(leaf, jparams, is_leaf=lambda x: isinstance(x, JaxQA))


def jax_mesh(dp: int, tp: int):
    import jax

    from lws_tpu.parallel import MeshSpec, build_mesh

    return build_mesh(MeshSpec(dp=dp, pp=1, cp=1, tp=tp), jax.devices()[:dp * tp])


def jax_shards(jcfg, jparams, mesh, tp_index: int) -> dict:
    """JAX's shards (shard_params_for_serving on `mesh`) of the device at
    (dp 0, tp `tp_index`), under the port's names and [out, in] layout, each
    with the shard_shape JAX's NamedSharding gives (transposed the same way)."""
    from lws_tpu.models.quant import QuantizedArray as JaxQA
    from lws_tpu.serving.engine import shard_params_for_serving

    dev = mesh.devices[0, 0, 0, tp_index]
    sharded = shard_params_for_serving(jparams, jcfg, mesh)

    def local(a):
        data = next(np.asarray(s.data) for s in a.addressable_shards if s.device == dev)
        assert data.shape == a.sharding.shard_shape(a.shape)
        return data

    out = {}

    for name, layout in (("embed", lambda x: x), ("lm_head", _T)):  # [V, D] in the port
        a = sharded[name]
        if isinstance(a, JaxQA):
            out[f"{name}.q"], out[f"{name}.scale"] = layout(local(a.q)), local(a.scale)
        else:
            out[f"{name}.weight"] = layout(local(a))
    out["final_norm"] = local(sharded["final_norm"])
    layers = sharded["layers"]
    for l in range(jcfg.n_layers):
        for name in ("attn_norm", "ffn_norm"):
            out[f"layers.{l}.{name}"] = local(layers[name])[l]
        if "router" in layers:
            out[f"layers.{l}.router"] = local(layers["router"])[l].T
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            a = layers[name]
            if isinstance(a, JaxQA):
                out[f"layers.{l}.{name}.q"] = np.swapaxes(local(a.q)[l], -1, -2)
                out[f"layers.{l}.{name}.scale"] = local(a.scale)[l]
            else:
                out[f"layers.{l}.{name}.weight"] = np.swapaxes(local(a)[l], -1, -2)
    return out


def _T(x):
    return np.swapaxes(x, -1, -2)


def assert_shards_equal_jax(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, (name, got[name].shape, want[name].shape)
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def tiny_cfg(**kw):
    import jax.numpy as jnp

    from lws_tpu.models.llama import LlamaConfig

    base = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                max_seq_len=64, dtype=jnp.float32, remat=False)
    base.update(kw)
    return LlamaConfig(**base)


def moe_cfg():
    import jax.numpy as jnp

    from lws_tpu.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_ff=128, n_experts=4, top_k=2, max_seq_len=256, dtype=jnp.float32,
                       param_dtype=jnp.float32, remat=False)


def jax_paged(jcfg, jparams, prompts, max_new, engine_kw, mesh=None, step_n=False):
    from lws_tpu.serving.paged_engine import PagedBatchEngine

    engine = PagedBatchEngine(jcfg, jparams, mesh=mesh, **engine_kw)
    rids = []
    for p in prompts:
        rids.append(engine.submit(p, max_new_tokens=max_new))
        if step_n:
            engine.step_n(2)
    engine.run_until_drained()
    return [engine.result(r) for r in rids]


PAGED_KW = dict(slots=3, max_len=32, block_size=8)
MOE_KW = dict(slots=4, max_len=256, block_size=16)


@pytest.fixture(scope="module")
def setups():
    """The JAX configs and weights of every case, with their port trees."""
    import jax

    from lws_tpu.models import init_params
    from lws_tpu.models.quant import quantize_params
    from lws_tpu_torch.models.convert import config_from_jax

    out = {}
    for name, jcfg in (("kv_off", tiny_cfg()), ("kv_on", tiny_cfg(kv_quant=True)),
                       ("moe", moe_cfg())):
        out[name] = (jcfg, jax.jit(lambda c=jcfg: init_params(c, jax.random.key(0)))())
    out["int8"] = (out["kv_on"][0], quantize_params(out["kv_on"][1]))
    moe_prompt = np.random.RandomState(3).randint(1, 120, size=10).astype(np.int32)
    return {name: dict(jcfg=jcfg, jparams=jp, cfg=config_from_jax(jcfg), tree=port_tree(jp),
                       prompts=[moe_prompt] if name == "moe" else PROMPTS,
                       max_new=8 if name == "moe" else 6,
                       engine=MOE_KW if name == "moe" else PAGED_KW, step_n=name == "moe")
            for name, (jcfg, jp) in out.items()}


def case(setup: dict, name: str, dp: int, tp: int, run: str = "paged", **kw) -> dict:
    return {"name": name, "dp": dp, "tp": tp, "run": run, "cfg": setup["cfg"],
            "tree": setup["tree"], "prompts": setup["prompts"], "max_new": setup["max_new"],
            "engine": setup["engine"], "step_n": setup["step_n"], **kw}


# The serving modes' configs, prompts and engines, as the three JAX tests
# set them up (their tiny_cfg, weights from jax.random.key(0)).
SYS = np.arange(1, 17, dtype=np.int32)  # 16 tokens = 2 full 8-blocks


def mode_setups() -> dict:
    rng3, rng0 = np.random.RandomState(3), np.random.RandomState(0)
    pat = rng0.randint(1, 60, size=8).astype(np.int32)
    return {
        "prefix": dict(cfg=dict(), engine=dict(slots=3, max_len=64, block_size=8),
                       mode=dict(prefix_cache=True),
                       prompts=[np.concatenate([SYS, [40, 41, 42]]).astype(np.int32),
                                np.concatenate([SYS, [50, 51]]).astype(np.int32)],
                       max_new=[6, 6], step_n=0),
        "chunked": dict(cfg=dict(vocab_size=256, max_seq_len=256),
                        engine=dict(slots=2, max_len=256, block_size=16),
                        mode=dict(prefill_chunk=16, interleave_steps=2),
                        prompts=[rng3.randint(1, 200, size=n).astype(np.int32) for n in (12, 70)],
                        max_new=[10, 10], step_n=2),
        "spec": dict(cfg=dict(vocab_size=64, max_seq_len=256),
                     engine=dict(slots=4, max_len=256, block_size=16), mode=dict(),
                     prompts=[np.tile(pat, 6), rng0.randint(1, 60, size=20).astype(np.int32)],
                     max_new=[24, 16], step_n=0, spec=(4, 3)),
    }


@pytest.fixture(scope="module")
def modes():
    """Each mode's JAX config and weights, and its want: JAX's single-device
    engine without the mode (as the JAX tests compare)."""
    import jax

    from lws_tpu.models import init_params
    from lws_tpu.serving.paged_engine import PagedBatchEngine
    from lws_tpu_torch.models.convert import config_from_jax

    out = {}
    for name, m in mode_setups().items():
        jcfg = tiny_cfg(**m["cfg"])
        jparams = jax.jit(lambda c=jcfg: init_params(c, jax.random.key(0)))()
        engine = PagedBatchEngine(jcfg, jparams, **m["engine"])
        rids = []
        for p, n in zip(m["prompts"], m["max_new"]):
            rids.append(engine.submit(p, max_new_tokens=n))
            if m["step_n"]:
                engine.step_n(m["step_n"])
        engine.run_until_drained()
        out[name] = dict(m, jcfg=jcfg, jparams=jparams, cfg=config_from_jax(jcfg),
                         tree=port_tree(jparams), want=[engine.result(r) for r in rids])
    return out


def mode_case(m: dict, name: str) -> dict:
    return {"name": name, "dp": 1, "tp": 2, "run": "mode", "cfg": m["cfg"], "tree": m["tree"],
            "prompts": m["prompts"], "max_new": m["max_new"], "step_n": m["step_n"],
            "engine": {**m["engine"], **m["mode"]}, "spec": m.get("spec")}


@pytest.fixture(scope="module")
def world2(setups, modes, tmp_path_factory):
    cases = [case(setups["kv_off"], "kv_off", 1, 2, shards=True),
             case(setups["kv_on"], "kv_on", 1, 2),
             case(setups["int8"], "int8", 1, 2, shards=True),
             case(setups["moe"], "moe", 1, 2, shards=True)]
    cases += [mode_case(modes[name], f"mode_{name}") for name in ("prefix", "chunked", "spec")]
    return spawn_cases(2, cases, tmp_path_factory.mktemp("world2"), __name__)


@pytest.fixture(scope="module")
def world4(setups, tmp_path_factory):
    cases = [case(setups["kv_off"], "dp2_tp2", 2, 2),
             case(setups["kv_off"], "refused", 1, 4, run="refused", engine_cls="paged")]
    return spawn_cases(4, cases, tmp_path_factory.mktemp("world4"), __name__)


def want_tokens(setup: dict, dp: int, tp: int) -> list:
    """JAX's tokens on the (dp, tp) mesh, after checking they equal JAX's
    single-device engine's."""
    args = (setup["jcfg"], setup["jparams"], setup["prompts"], setup["max_new"], setup["engine"])
    single = jax_paged(*args, step_n=setup["step_n"])
    on_mesh = jax_paged(*args, mesh=jax_mesh(dp, tp), step_n=setup["step_n"])
    assert on_mesh == single
    return single


def check_ranks(results: list, name: str, want: list, cfg, tp: int) -> None:
    for r, res in enumerate(results):
        got = res[name]
        assert got["tokens"] == want, (r, got["tokens"], want)
        for shape in got["pool"]:  # k, v (and their scales): Hkv/tp heads on every rank
            assert shape[3] == cfg.n_kv_heads // tp, (r, shape)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv_off", "kv_on"])
def test_paged_tp_matches_jax_and_single_device(setups, world2, kv_quant):
    name = "kv_on" if kv_quant else "kv_off"
    check_ranks(world2, name, want_tokens(setups[name], 1, 2), setups[name]["cfg"], 2)
    if kv_quant:
        assert len(world2[0][name]["pool"]) == 4  # the int8 scale pools shard with the values


def test_paged_tp_with_dp_axis_present(setups, world4):
    """(dp=2, tp=2): pools replicate over dp and shard over tp; all four
    ranks emit JAX's tokens."""
    check_ranks(world4, "dp2_tp2", want_tokens(setups["kv_off"], 2, 2),
                setups["kv_off"]["cfg"], 2)


def test_paged_tp_rejects_indivisible_heads(setups, world4):
    from lws_tpu.serving.paged_engine import PagedBatchEngine

    with pytest.raises(ValueError, match="n_kv_heads"):
        PagedBatchEngine(setups["kv_off"]["jcfg"], setups["kv_off"]["jparams"], slots=2,
                         max_len=32, block_size=8, mesh=jax_mesh(1, 8))
    for res in world4:
        assert res["refused"] == "n_kv_heads=2 not divisible by tp=4"


def test_paged_tp_int8_weights_and_kv(setups, world2):
    """int8 weights (quantize_params) with int8 KV through the paged engine
    at tp = 2: scales split with their output channels, stay whole for wo
    and w_down."""
    check_ranks(world2, "int8", want_tokens(setups["int8"], 1, 2), setups["int8"]["cfg"], 2)


def test_moe_tp_mesh_expert_parallel(setups, world2):
    """Experts over tp: each rank runs E/tp experts of JAX's shard; the
    partial outputs all-reduce to the single-device trajectory."""
    check_ranks(world2, "moe", want_tokens(setups["moe"], 1, 2), setups["moe"]["cfg"], 2)
    for r, res in enumerate(world2):
        w = res["moe"]["shards"]["layers.0.w_gate.weight"]
        assert w.shape[0] == setups["moe"]["cfg"].n_experts // 2, (r, w.shape)


@pytest.mark.parametrize("name", ["kv_off", "int8", "moe"])
def test_every_rank_holds_jax_shard(setups, world2, name):
    """params_from_jax(..., mesh=...) lands rank r's tensors as JAX's
    NamedSharding shard of tp index r: equal shard_shape and equal values,
    int8 scales included."""
    s = setups[name]
    mesh = jax_mesh(1, 2)
    for r, res in enumerate(world2):
        assert_shards_equal_jax(res[name]["shards"], jax_shards(s["jcfg"], s["jparams"], mesh, r))


def test_ranks_agree(world2, world4):
    for results in (world2, world4):
        for res in results[1:]:
            for name, got in res.items():
                want = results[0][name]
                assert (got if isinstance(got, str) else got["tokens"]) == \
                    (want if isinstance(want, str) else want["tokens"]), name



def test_prefix_cache_under_tp_mesh(modes, world2):
    """tests/test_prefix_cache.py:167: under tp = 2 the prefix cache's
    streams equal JAX's single-device engine without the cache, and the
    second prompt hits the first's two system-prompt blocks."""
    for res in world2:
        got = res["mode_prefix"]
        assert got["tokens"] == modes["prefix"]["want"]
        assert got["stats_prefix"]["hit_tokens"] == 16 and got["stats_prefix"]["hit_blocks"] == 2


def test_chunked_admission_token_exact_tp_mesh(modes, world2):
    """tests/test_chunked_admission.py:145: chunked admission with
    interleaved decode steps under tp = 2 equals JAX's plain single-device
    engine."""
    for res in world2:
        got = res["mode_chunked"]
        assert got["tokens"] == modes["chunked"]["want"]
        assert got["stats"]["chunked_admissions"] == 1  # the 70-token prompt
        assert got["stats"]["interleaved_decode_steps"] > 0


def test_paged_speculative_tp_mesh_exact(modes, world2):
    """tests/test_paged_speculative.py:95: device-resident speculation
    under tp = 2 equals JAX's plain single-device engine, and accepts
    drafts."""
    for res in world2:
        got = res["mode_spec"]
        assert got["tokens"] == modes["spec"]["want"]
        assert got["stats"]["spec_accepted"] > 0
