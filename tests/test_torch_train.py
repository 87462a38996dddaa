"""The port's training path on one device (lws_tpu_torch/models/llama.py
`forward`/`loss_fn`, models/train.py) against the JAX package's, on JAX's
weights converted through models/convert.py, f32 tiny configs.

Each layer is held separately, since Adam amplifies noise: after its first
step an update is about +-lr wherever |g| >> eps, so a gradient element near
0 whose sign differs between the frameworks moves its parameter by 2 lr.
  * forward (logits, aux) and loss_fn (total, ce, aux) against JAX's, dense
    and MoE (at a capacity that drops tokens), with masked targets;
  * every parameter's gradient against jax.grad(loss_fn);
  * the optimizer fed JAX's own gradients against optax (two updates, and
    one whose clip triggers);
  * three make_train_step steps against JAX's make_train_step on a
    one-device mesh: losses, and parameters and both moments after the
    steps, with the exemption for elements whose gradient is tiny written
    into the check (`assert_step_close`);
  * remat on against off; a one-rank gloo mesh against mesh=None; GPipe at
    pp = 1 and the ring at cp = 1 against the plain forward; causality.
Tolerances (f32): GRAD_TOL of each tensor's largest value for gradients and
forward values (the frameworks sum in other orders: about 1e-7 measured);
PARAM_ATOL for parameters after steps.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lws_tpu.models import LlamaConfig as JaxConfig
from lws_tpu.models import init_params as jax_init
from lws_tpu.models.llama import forward as jax_forward
from lws_tpu.models.llama import loss_fn as jax_loss_fn
from lws_tpu_torch.models import llama as tl
from lws_tpu_torch.models.convert import config_from_jax, params_from_jax
from lws_tpu_torch.models.train import (
    AdamW,
    make_optimizer,
    make_train_step,
    value_and_grad,
)

GRAD_TOL = 1e-5   # x max |JAX| of the tensor: gradients, logits, moments
PARAM_ATOL = 1e-6  # parameters after steps (lr 3e-4 moves each by ~3e-4 a step)
STEPS = 3


def jax_cfg(moe: bool = False, **kw) -> JaxConfig:
    base = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                max_seq_len=64, remat=False, dtype=jnp.float32)
    if moe:
        base.update(n_experts=4, top_k=2, capacity_factor=1.0)  # C below S * k / E: drops
    base.update(kw)
    return JaxConfig(**base)


def batch_tokens(seed: int = 1, B: int = 4, S: int = 17) -> np.ndarray:
    """Random tokens; row 1 padded with -1 from position 12 (its targets
    there are masked)."""
    toks = np.random.default_rng(seed).integers(0, 128, (B, S)).astype(np.int32)
    toks[1, 12:] = -1
    return toks


def port_model(jparams, cfg, mesh=None) -> tl.Llama:
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu", mesh=mesh)


def port_named(jtree, cfg) -> dict:
    """A JAX params-shaped tree (grads, moments) under the port's names."""
    return {n: t.detach().clone() for n, t in port_model(jtree, cfg).named_parameters()}


def assert_close(got: torch.Tensor, want, name: str, tol: float = GRAD_TOL) -> None:
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= tol * scale, f"{name}: max |err| {err:.3e} > {tol} x {scale:.3e}"


def assert_named_close(got: dict, want: dict, tol: float = GRAD_TOL) -> None:
    assert sorted(got) == sorted(want)
    for n in want:
        assert_close(got[n], want[n].numpy(), n, tol)


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "moe"])
def setup(request):
    jcfg = jax_cfg(moe=request.param)
    jparams = jax_init(jcfg, jax.random.key(0))
    return jcfg, jparams, config_from_jax(jcfg)


def test_config_from_jax_keeps_the_training_fields():
    jcfg = jax_cfg(remat=True, context_parallel=True, pipeline_microbatches=4,
                   aux_loss_coef=0.02)
    cfg = config_from_jax(jcfg)
    assert (cfg.remat, cfg.context_parallel, cfg.pipeline_microbatches, cfg.aux_loss_coef) \
        == (True, True, 4, 0.02)
    d = tl.LlamaConfig()
    assert (d.remat, d.context_parallel, d.pipeline_microbatches, d.aux_loss_coef) \
        == (True, False, 0, 0.01)  # JAX's defaults


def test_forward_and_loss_match_jax(setup):
    jcfg, jparams, cfg = setup
    toks = batch_tokens()
    want_logits, want_aux = jax_forward(jparams, jnp.asarray(toks[:, :-1]), jcfg)
    want_loss, want_m = jax_loss_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    model = port_model(jparams, cfg)
    logits, aux = tl.forward(model, torch.from_numpy(toks[:, :-1]))
    assert logits.dtype == torch.float32 and logits.shape == (4, 16, 128)
    assert_close(logits, want_logits, "logits")
    assert abs(float(aux) - float(want_aux)) <= GRAD_TOL * max(abs(float(want_aux)), 1.0)
    if jcfg.n_experts:
        assert float(want_aux) > 0
    loss, m = tl.loss_fn(model, {"tokens": torch.from_numpy(toks)})
    for got, want in ((loss, want_loss), (m["ce"], want_m["ce"]), (m["aux"], want_m["aux"])):
        assert abs(float(got) - float(want)) <= GRAD_TOL * abs(float(want)) + 1e-7


def test_every_gradient_matches_jax_grad(setup):
    jcfg, jparams, cfg = setup
    toks = batch_tokens()
    (want_loss, _), jgrads = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    model = port_model(jparams, cfg)
    loss, _, grads = value_and_grad(model, torch.from_numpy(toks))
    assert abs(float(loss) - float(want_loss)) <= GRAD_TOL * float(want_loss)
    want = port_named(jgrads, cfg)
    assert_named_close(grads, want)
    for name in ("layers.0.wq.weight", "layers.0.wk.weight", "layers.0.wv.weight"):
        assert float(grads[name].abs().max()) > 0, f"{name}: no gradient through attention"
    assert all(p.grad is None for p in model.parameters())


@pytest.mark.parametrize("clip", [False, True], ids=["under_the_norm", "clipped"])
def test_optimizer_matches_optax_on_jax_gradients(setup, clip):
    """Two updates from JAX's own gradients, scaled so that their global
    norm is under 1 (x 0.1) or over it (x 10: the clip triggers): updates,
    mu, nu and count equal optax's."""
    import optax

    from lws_tpu.models.train import make_optimizer as jax_make_optimizer

    jcfg, jparams, cfg = setup
    toks = batch_tokens()
    jgrads = jax.grad(lambda p: jax_loss_fn(p, {"tokens": jnp.asarray(toks)}, jcfg)[0])(jparams)
    jgrads = jax.tree.map(lambda g: g * (10.0 if clip else 0.1), jgrads)
    norm = float(optax.global_norm(jgrads))
    assert (norm > 1.0) == clip, norm
    jopt = jax_make_optimizer()
    jstate = jopt.init(jparams)
    opt = make_optimizer()
    named = {n: t.detach().clone() for n, t in port_model(jparams, cfg).named_parameters()}
    state = opt.init(named)
    grads = port_named(jgrads, cfg)
    jp = jparams
    for _ in range(2):
        jupd, jstate = jopt.update(jgrads, jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        upd, state = opt.update(grads, state, named)
        named = {n: named[n] + upd[n] for n in named}
        assert_named_close(upd, port_named(jupd, cfg))
        assert int(state["count"]) == int(jstate[1][0].count)
        assert_named_close(state["mu"], port_named(jstate[1][0].mu, cfg))
        assert_named_close(state["nu"], port_named(jstate[1][0].nu, cfg))
    assert_named_close(named, port_named(jp, cfg), tol=1e-6)


def assert_step_close(got: dict, want: dict, small: dict, lr: float, steps: int,
                      what: str) -> None:
    """Parameters after `steps` Adam steps: within PARAM_ATOL, except
    elements whose JAX gradient was under GRAD_TOL of its tensor's largest at
    some step (`small`): Adam turns their rounding into a sign, so they may
    differ by up to 2 lr a step. The exempt share is bounded too."""
    exempt = total = 0
    for n in want:
        w, g = want[n].numpy(), got[n].detach().numpy()
        err = np.abs(g - w)
        ok = err <= PARAM_ATOL
        tiny = small[n]
        assert np.all(ok | (tiny & (err <= 2 * lr * steps + PARAM_ATOL))), \
            f"{what} {n}: max |err| {err.max():.3e} outside the exemption"
        exempt += int(np.sum(~ok & tiny))
        total += w.size
    assert exempt <= 1e-3 * total, f"{what}: {exempt} of {total} elements exempt"


def jax_single_device_steps(jcfg, jparams, toks, steps: int = STEPS):
    """JAX's make_train_step on a one-device mesh from `jparams`: losses,
    params, mu, nu after `steps`, and per parameter where |grad| was small
    (under GRAD_TOL of the tensor's largest) at any step."""
    from lws_tpu.models.train import make_optimizer as jax_make_optimizer
    from lws_tpu.models.train import make_train_step as jax_make_train_step
    from lws_tpu.parallel import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(), jax.devices()[:1])
    opt = jax_make_optimizer()
    step = jax_make_train_step(jcfg, mesh, opt)
    grad_fn = jax.jit(jax.grad(lambda p, b: jax_loss_fn(p, b, jcfg)[0]))
    params = jax.tree.map(jnp.copy, jparams)  # the step donates its inputs
    opt_state = opt.init(params)
    batch = {"tokens": jnp.asarray(toks)}
    losses, small = [], None
    for _ in range(steps):
        g = grad_fn(params, batch)
        tiny = jax.tree.map(lambda x: np.abs(np.asarray(x)) <= GRAD_TOL * np.abs(np.asarray(x)).max(), g)
        small = tiny if small is None else jax.tree.map(np.logical_or, small, tiny)
        params, opt_state, loss, _ = step(params, opt_state, batch)
        losses.append(float(loss))
    return losses, params, opt_state[1][0].mu, opt_state[1][0].nu, small


def test_three_train_steps_match_jax(setup):
    jcfg, jparams, cfg = setup
    toks = batch_tokens()
    losses, jp, jmu, jnu, small = jax_single_device_steps(jcfg, jparams, toks)
    model = port_model(jparams, cfg)
    opt = make_optimizer()
    state = opt.init(model)
    run = make_train_step(cfg, None, opt)
    got = []
    for _ in range(STEPS):
        model, state, loss, m = run(model, state, {"tokens": toks})
        got.append(float(loss))
    np.testing.assert_allclose(got, losses, rtol=1e-6)
    assert got[-1] < got[0]
    small = {n: t.numpy().astype(bool) for n, t in port_named(
        jax.tree.map(lambda x: x.astype(np.float32), small), cfg).items()}
    assert_step_close(dict(model.named_parameters()), port_named(jp, cfg), small, opt.lr,
                      STEPS, "params")
    assert_named_close(state["mu"], port_named(jmu, cfg), tol=1e-4)
    assert_named_close(state["nu"], port_named(jnu, cfg), tol=1e-4)
    assert int(state["count"]) == STEPS


def test_remat_matches_no_remat(setup):
    jcfg, jparams, cfg = setup
    toks = torch.from_numpy(batch_tokens())
    l0, _, g0 = value_and_grad(port_model(jparams, cfg), toks)
    cfg_r = dataclasses.replace(cfg, remat=True)
    l1, _, g1 = value_and_grad(port_model(jparams, cfg_r), toks)
    assert abs(float(l1) - float(l0)) <= 1e-6 * float(l0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-7, msg=n)


def test_degenerate_gpipe_and_ring_match_the_plain_forward(setup):
    """GPipe with one stage and 2 microbatches, and the ring over a cp of
    one rank (context_parallel=True, no mesh: a warning), give the plain
    forward's logits, aux and gradients (GPipe's aux is per microbatch, so
    it is compared on the dense model only)."""
    jcfg, jparams, cfg = setup
    toks = torch.from_numpy(batch_tokens())
    base = port_model(jparams, cfg)
    want_logits, want_aux = tl.forward(base, toks[:, :-1])
    l0, _, g0 = value_and_grad(base, toks)
    for what, c in (("gpipe", dataclasses.replace(cfg, pipeline_microbatches=2)),
                    ("ring", dataclasses.replace(cfg, context_parallel=True))):
        model = port_model(jparams, c)
        if what == "ring":
            with pytest.warns(UserWarning, match="cp axis has size 1"):
                logits, aux = tl.forward(model, toks[:, :-1])
        else:
            logits, aux = tl.forward(model, toks[:, :-1])
        torch.testing.assert_close(logits, want_logits, rtol=1e-5, atol=1e-5, msg=what)
        if what == "ring" or not cfg.n_experts:
            assert abs(float(aux) - float(want_aux)) <= 1e-6
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                l1, _, g1 = value_and_grad(model, toks)
            assert abs(float(l1) - float(l0)) <= 1e-6 * float(l0)
            for n in g0:
                torch.testing.assert_close(g1[n], g0[n], rtol=1e-4, atol=1e-6, msg=f"{what} {n}")


def test_gpipe_refuses_context_parallel(setup):
    jcfg, jparams, cfg = setup
    c = dataclasses.replace(cfg, pipeline_microbatches=2, context_parallel=True)
    with pytest.raises(NotImplementedError, match="pipeline_microbatches with context_parallel"):
        tl.forward(port_model(jparams, c), torch.zeros(4, 8, dtype=torch.long))


def test_causality():
    """Changing a future token must not change earlier logits
    (tests/test_model.py::test_causality)."""
    cfg = config_from_jax(jax_cfg())
    model = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    t1 = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8]])
    t2 = t1.clone()
    t2[0, -1] = 99
    with torch.no_grad():
        l1, _ = tl.forward(model, t1)
        l2, _ = tl.forward(model, t2)
    torch.testing.assert_close(l1[0, :-1], l2[0, :-1], atol=1e-5, rtol=0)
    assert not torch.allclose(l1[0, -1], l2[0, -1], atol=1e-5)


@pytest.fixture
def one_rank_group():
    import torch.distributed as dist

    from lws_tpu_torch.parallel import initialize_from_env

    initialize_from_env(env={}, device="cpu", group_of_one=True)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_step_equals_no_mesh(one_rank_group):
    """dp = pp = cp = tp = 1 on a one-rank gloo group: every collective is
    a copy, so a step leaves the same parameters and moments as mesh=None."""
    from lws_tpu_torch.parallel import MeshSpec, build_mesh

    cfg = config_from_jax(jax_cfg(moe=True))
    mesh = build_mesh(MeshSpec())
    toks = batch_tokens()
    out = []
    for m in (None, mesh):
        model = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", mesh=m)
        opt = make_optimizer()
        model, state, loss, _ = make_train_step(cfg, m, opt)(model, opt.init(model),
                                                            {"tokens": toks})
        out.append((float(loss), dict(model.named_parameters()), state))
    assert out[0][0] == out[1][0]
    for n, p in out[0][1].items():
        assert torch.equal(p, out[1][1][n]), n
        assert torch.equal(out[0][2]["nu"][n], out[1][2]["nu"][n]), n


def test_init_params_with_a_mesh_is_the_shard_of_the_full_draw(one_rank_group):
    from lws_tpu_torch.parallel import MeshSpec, build_mesh

    cfg = config_from_jax(jax_cfg(moe=True))
    full = tl.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    mine = tl.init_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                          mesh=build_mesh(MeshSpec()))
    for (n, a), (m, b) in zip(full.named_parameters(), mine.named_parameters()):
        assert n == m and torch.equal(a, b), n


def test_adamw_is_optax_arithmetic_by_hand():
    """One element through both steps by hand: clip, moments, bias
    correction with the incremented count, decay on the parameter, -lr."""
    opt = AdamW(lr=0.1, weight_decay=0.5)
    p = {"w": torch.tensor([2.0])}
    g = {"w": torch.tensor([3.0])}  # norm 3 > 1: clipped to 1
    upd, st = opt.update(g, opt.init(p), p)
    mu, nu = 0.1 * 1.0, 0.05 * 1.0
    want = -0.1 * ((mu / 0.1) / (np.sqrt(nu / 0.05) + 1e-8) + 0.5 * 2.0)
    assert abs(float(upd["w"]) - want) < 1e-6
    assert abs(float(st["mu"]["w"]) - mu) < 1e-7 and abs(float(st["nu"]["w"]) - nu) < 1e-7


def test_moe_configs_drop_tokens(monkeypatch):
    """The MoE cases run at a capacity that drops tokens: in the training
    forward of this file's batch and of tests/test_torch_train_parallel.py's,
    some layer's routing keeps fewer than B * S * top_k expert slots."""
    from tests.test_torch_train_parallel import batch_tokens as parallel_tokens
    from tests.test_torch_train_parallel import jax_cfg as parallel_cfg

    kept, route = [], tl.moe_route

    def spy(x, *a, **kw):
        out = route(x, *a, **kw)
        kept.append((float(out[1].sum()), x.shape[0] * x.shape[1]))
        return out

    monkeypatch.setattr(tl, "moe_route", spy)
    for jcfg, toks in ((jax_cfg(moe=True), batch_tokens()),
                       (parallel_cfg(moe=True), parallel_tokens())):
        cfg = config_from_jax(jcfg)
        kept.clear()
        with torch.no_grad():
            tl.forward(port_model(jax_init(jcfg, jax.random.key(0)), cfg),
                       torch.from_numpy(toks[:, :-1]))
        assert len(kept) == cfg.n_layers
        assert any(k < n * cfg.top_k for k, n in kept), kept
