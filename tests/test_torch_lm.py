"""The port's LM family against the reference's: the building blocks
(``rms_norm``, RoPE, chunked and decode attention, the attention block),
the five LM architectures' smoke configs through ``forward``,
``loss_fn``, ``prefill`` and ten ``serve_step``s, the token stream, the
parameter count and the registry of all ten architectures.

The reference's parameters (``transformer.init``) carry across with
``params_from_numpy``; inputs are made with numpy from a seed and handed
to both packages.  Float32: rtol 1e-5 / atol 1e-5 (the reference's own
decode test allows 2e-4).  Bfloat16: relative Frobenius error at most
1e-2, as the GNNs' bfloat16 checks (one bfloat16 rounding, 2^-8, per
op, where the two frameworks round the same float32 values).  The
reference's functions run under ``jax.jit`` (one compile per case).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RREG
from repro.data import lm as RLM
from repro.launch import cells as RCELLS
from repro.models import attention as RA
from repro.models import common as RC
from repro.models import transformer as RT

import _torch_util  # noqa: F401  (caps torch threads)
from repro_torch.configs import registry as TREG
from repro_torch.data import lm as TLM
from repro_torch.launch import cells as TCELLS
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.models.common import params_from_numpy

LM_ARCHS = ["deepseek_coder_33b", "qwen3_14b", "internlm2_20b",
            "arctic_480b", "grok1_314b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    """A JAX or torch array as float32 (bfloat16 widened exactly)."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, dtype="float32"):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 1e-2, err


def both(x, dtype="float32"):
    """numpy float32 ``x`` as (JAX, torch) arrays in ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.tensor(x).to(td)


def port_params(params):
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


# --------------------------------------------------------------------- #
# common: norms and RoPE
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    (jx, tx), (js, ts) = both(x, dtype), both(scale, dtype)
    got, want = TC.rms_norm(tx, ts), RC.rms_norm(jx, js)
    assert got.dtype == DTYPES[dtype][1]
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    rng = np.random.default_rng(1)
    pos = np.array([[0, 3, 17, 250], [1, 2, 3, 4]], np.int32)
    jc, js = RC.rope_freqs(32, 1e6, jnp.asarray(pos))
    tc, ts = TC.rope_freqs(32, 1e6, torch.as_tensor(pos))
    close(tc, jc)
    close(ts, js)
    x = rng.standard_normal((2, 4, 3, 32)).astype(np.float32)
    jx, tx = both(x, dtype)
    got = TC.apply_rope(tx, tc, ts)
    assert got.dtype == DTYPES[dtype][1]
    close(got, RC.apply_rope(jx, jc, js), dtype)


def test_count_params_and_cast_tree():
    cfg = importlib.import_module("repro.configs.arctic_480b").smoke_config()
    params = RT.init(jax.random.PRNGKey(0), cfg)
    tp = port_params(params)
    assert TC.count_params(tp) == RC.count_params(params)
    cast = TC.cast_tree({**tp, "ids": torch.arange(3)}, torch.bfloat16)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["layers"]["moe"]["w1"].dtype == torch.bfloat16
    assert cast["ids"].dtype == torch.int64


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
def qkv(rng, b, s, hq, hkv, hd, dtype="float32"):
    return [both(rng.standard_normal((b, s, h, hd)).astype(np.float32),
                 dtype) for h in (hq, hkv, hkv)]


def test_repeat_kv():
    k = np.random.default_rng(2).standard_normal((2, 5, 3, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        TA._repeat_kv(torch.tensor(k), 4).numpy(),
        np.asarray(RA._repeat_kv(jnp.asarray(k), 4)))


@pytest.mark.parametrize("s,chunk,window,causal", [
    (16, 8, None, True),        # two chunks
    (32, 8, None, True),        # four chunks
    (32, 8, 4, True),           # sliding window: whole chunks masked
    (24, 8, None, False),
    (20, 64, None, True),       # one chunk of the whole sequence
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_attention(s, chunk, window, causal, dtype):
    rng = np.random.default_rng(s + chunk)
    (jq, tq), (jk, tk), (jv, tv) = qkv(rng, 2, s, 6, 2, 16, dtype)
    want = RA.gqa_attention(jq, jk, jv, causal=causal, chunk_size=chunk,
                            window=window)
    got = TA.gqa_attention(tq, tk, tv, causal=causal, chunk_size=chunk,
                           window=window)
    assert got.dtype == tq.dtype
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ragged_length(dtype):
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = qkv(rng, 3, 1, 8, 2, 16, dtype)
    kc = rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
    (jkc, tkc), (jvc, tvc) = both(kc, dtype), both(vc, dtype)
    length = np.array([1, 7, 12], np.int32)
    want = RA.decode_attention(jq, jkc, jvc, jnp.asarray(length))
    got = TA.decode_attention(tq, tkc, tvc, torch.as_tensor(length))
    close(got, want, dtype)


def _attn_cfg(qk_norm):
    rc = RT.LMConfig(n_layers=1, d_model=48, n_heads=6, n_kv_heads=2,
                     head_dim=8, d_ff=64, vocab=50, qk_norm=qk_norm,
                     dtype=jnp.float32, attn_chunk=4, rope_theta=1e6,
                     remat="none")
    tc = TT.LMConfig(**{f.name: getattr(rc, f.name)
                        for f in dataclasses.fields(rc)
                        if f.name not in ("dtype", "param_dtype")},
                     dtype=torch.float32, param_dtype=torch.float32)
    return rc, tc


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_attention_block(qk_norm, cached):
    rc, tc = _attn_cfg(qk_norm)
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: a[0],
                          RT.init(jax.random.PRNGKey(5), rc)["layers"])
    p = {k: np.asarray(v) for k, v in params["attn"].items()}
    if qk_norm:    # scales other than the init's ones
        p["q_norm"] = (1 + 0.2 * rng.standard_normal(8)).astype(np.float32)
        p["k_norm"] = (1 + 0.2 * rng.standard_normal(8)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = params_from_numpy(p, device="cpu")
    b, s = 2, (1 if cached else 12)
    x = rng.standard_normal((b, s, 48)).astype(np.float32)
    if not cached:
        want, (wk, wv, _) = RA.attention_block(jnp.asarray(x), jp, rc)
        got, (gk, gv, gl) = TA.attention_block(torch.tensor(x), tp, tc)
        assert gl is None
        for g, w in ((got, want), (gk, wk), (gv, wv)):
            close(g, w)
        return
    kc = rng.standard_normal((b, 10, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((b, 10, 2, 8)).astype(np.float32)
    length = np.array([3, 6], np.int32)
    pos = length[:, None]
    want, (wk, wv, wl) = RA.attention_block(
        jnp.asarray(x), jp, rc, positions=jnp.asarray(pos),
        kv_cache=(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(length)))
    tk, tv = torch.tensor(kc), torch.tensor(vc)
    got, (gk, gv, gl) = TA.attention_block(
        torch.tensor(x), tp, tc, positions=torch.as_tensor(pos),
        kv_cache=(tk, tv, torch.as_tensor(length)))
    assert gk is tk and gv is tv            # written in place
    close(got, want)
    close(gk, wk)
    close(gv, wv)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


# --------------------------------------------------------------------- #
# the five architectures' smoke configs end to end
# --------------------------------------------------------------------- #
def _configs(name, dtype="float32"):
    rc = importlib.import_module(f"repro.configs.{name}").smoke_config()
    tc = importlib.import_module(f"repro_torch.configs.{name}").smoke_config()
    if dtype == "bfloat16":
        rc = dataclasses.replace(rc, dtype=jnp.bfloat16)
        tc = dataclasses.replace(tc, dtype=torch.bfloat16)
    return rc, tc


@functools.lru_cache(maxsize=None)
def _reference_run(name, dtype, b, s, prompt, smax, steps):
    """The reference's forward, loss, prefill and ``steps`` greedy-free
    serve_steps (teacher-forced tokens) on seeded tokens, as numpy."""
    rc, _ = _configs(name, dtype)
    params = RT.init(jax.random.PRNGKey(0), rc)
    tokens = np.random.default_rng(11).integers(
        0, rc.vocab, (b, s)).astype(np.int32)

    @jax.jit
    def whole(params, tokens):
        return (RT.forward(params, tokens, rc),
                RT.loss_fn(params, tokens, rc),
                RT.prefill(params, tokens[:, :prompt], rc))

    (logits, aux), (loss, metrics), (plog, pk, pv) = whole(params, tokens)
    step = jax.jit(functools.partial(RT.serve_step, cfg=rc))
    shape = (rc.n_layers, b, smax, rc.n_kv_heads, rc.head_dim)
    kc = jnp.zeros(shape, rc.dtype).at[:, :, :prompt].set(pk)
    vc = jnp.zeros(shape, rc.dtype).at[:, :, :prompt].set(pv)
    cache = (kc, vc, jnp.full((b,), prompt, jnp.int32))
    steps_out = []
    for i in range(steps):
        lg, cache = step(params, jnp.asarray(tokens[:, prompt + i:
                                                    prompt + i + 1]), cache)
        steps_out.append(np.asarray(jnp.asarray(lg, jnp.float32)))
    out = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32))
                       if jnp.issubdtype(a.dtype, jnp.floating)
                       else np.asarray(a),
                       dict(logits=logits, aux=aux, loss=loss,
                            ce=metrics["ce"], plog=plog, pk=pk, pv=pv,
                            kc=cache[0], vc=cache[1], length=cache[2]))
    out["steps"] = steps_out
    return jax.tree.map(np.asarray, params), tokens, out


@pytest.mark.parametrize("name", LM_ARCHS)
def test_smoke_config_forward_loss_prefill_and_serve(name):
    """Every LM smoke config (qk_norm, MoE with and without the dense
    residual, both ``expert_shard`` values): forward, loss_fn, prefill
    (logits and K/V) and ten serve_steps from the prefilled cache (the
    cache compared after the last), against the reference's."""
    b, s, prompt, smax, steps = 2, 64, 54, 72, 10
    params, tokens, want = _reference_run(name, "float32", b, s, prompt,
                                          smax, steps)
    _, tc = _configs(name)
    tp = params_from_numpy(params, device="cpu")
    tt = torch.as_tensor(tokens)
    with torch.inference_mode():
        logits, aux = TT.forward(tp, tt, tc)
        loss, metrics = TT.loss_fn(tp, tt, tc)
        plog, pk, pv = TT.prefill(tp, tt[:, :prompt], tc)
        close(logits, want["logits"])
        close(aux, want["aux"])
        close(loss, want["loss"])
        close(metrics["ce"], want["ce"])
        close(plog, want["plog"])
        close(pk, want["pk"])
        close(pv, want["pv"])
        shape = (tc.n_layers, b, smax, tc.n_kv_heads, tc.head_dim)
        kc, vc = torch.zeros(shape), torch.zeros(shape)
        kc[:, :, :prompt], vc[:, :, :prompt] = pk, pv
        cache = (kc, vc, torch.full((b,), prompt, dtype=torch.int32))
        for i in range(steps):
            lg, cache = TT.serve_step(tp, tt[:, prompt + i:prompt + i + 1],
                                      cache, tc)
            close(lg, want["steps"][i])
        assert cache[0] is kc and cache[1] is vc       # in place
        close(kc, want["kc"])
        close(vc, want["vc"])
        np.testing.assert_array_equal(cache[2].numpy(), want["length"])


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", ["qwen3_14b", "arctic_480b"])
def test_smoke_config_in_bfloat16(name):
    """The compute dtype bfloat16 (float32 parameters cast per layer, as
    the full configs run).  Layer 0's prefill K/V, one chain of ops deep,
    within 1e-2 relative Frobenius of the reference's.  The logits sit
    two layers and some twenty bfloat16 roundings deep, where the two
    frameworks' independent roundings alone part them by ~1e-2 (each is
    ~1.4e-2 from the float32 forward): the port's bfloat16 forward and
    prefill logits must be no farther from the float32 forward than the
    reference's bfloat16 ones are, within 10%."""
    params, tokens, want = _reference_run(name, "bfloat16", 2, 32, 32, 32, 0)
    _, _, exact = _reference_run(name, "float32", 2, 32, 32, 32, 0)
    _, tc = _configs(name, "bfloat16")
    tp = params_from_numpy(params, device="cpu")
    with torch.inference_mode():
        logits, _ = TT.forward(tp, torch.as_tensor(tokens), tc)
        plog, pk, pv = TT.prefill(tp, torch.as_tensor(tokens), tc)
    assert logits.dtype == pk.dtype == torch.bfloat16
    close(pk[0], want["pk"][0], "bfloat16")
    close(pv[0], want["pv"][0], "bfloat16")
    for got, ref, key in ((logits, want["logits"], "logits"),
                          (plog, want["plog"], "plog")):
        port_err, ref_err = _rel(got, exact[key]), _rel(ref, exact[key])
        assert port_err <= 1.1 * ref_err, (key, port_err, ref_err)
        assert _rel(got, ref) <= 2 * ref_err, key


def test_lm_module_holds_the_reference_tree():
    """``LM`` holds the tree as parameters; ``params()`` reads it back in
    the reference's layout, leaf for leaf; its forward is the
    module-level one; remat changes no output."""
    rc, tc = _configs("arctic_480b")
    params = RT.init(jax.random.PRNGKey(0), rc)
    model = TT.LM(tc, device="cpu", params=port_params(params))
    back = model.params()
    assert jax.tree.structure(jax.tree.map(np.asarray, params)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.detach().numpy(), back))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(
            jax.tree.map(lambda t: t.detach().numpy(), back))):
        np.testing.assert_array_equal(np.asarray(a), b)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, tc.vocab, (2, 16)))
    with torch.no_grad():
        want, _ = TT.forward(back, tokens, tc)
    remat = TT.LM(dataclasses.replace(tc, remat="full"), device="cpu",
                  params=port_params(params))
    got, aux = remat(tokens)                 # grad mode: checkpointed
    assert got.requires_grad
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    aux.backward()                           # the router's gradient flows
    assert remat.layer_blocks["moe"]["wg"].grad is not None


def test_init_layout_matches_the_reference():
    """``init`` draws the reference's tree: the same keys, shapes and
    dtypes (its numbers are torch's), with unit norms and the fan-in
    scales."""
    for name in LM_ARCHS:
        rc, tc = _configs(name)
        want = jax.eval_shape(functools.partial(RT.init, cfg=rc),
                              jax.random.PRNGKey(0))
        got = TT.init(torch.Generator().manual_seed(0), tc, device="cpu")
        assert jax.tree.structure(want) == jax.tree.structure(
            jax.tree.map(lambda t: 0, got))
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert tuple(w.shape) == tuple(g.shape)
            assert g.dtype == torch.float32
        assert torch.equal(got["layers"]["ln1"], torch.ones_like(
            got["layers"]["ln1"]))
        wq = got["layers"]["attn"]["wq"]
        assert abs(float(wq.std()) * tc.d_model ** 0.5 - 1) < 0.1


# --------------------------------------------------------------------- #
# data, cells, registry
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("step,batch,seq,vocab,seed", [
    (0, 4, 16, 97, 0), (7, 2, 33, 151_936, 3)])
def test_lm_batch_bit_equal(step, batch, seq, vocab, seed):
    want = RLM.lm_batch(step, batch, seq, vocab, seed)
    got = TLM.lm_batch(step, batch, seq, vocab, seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_param_flops(name):
    for size in ("CONFIG", "smoke"):
        rmod = importlib.import_module(f"repro.configs.{name}")
        tmod = importlib.import_module(f"repro_torch.configs.{name}")
        rc, tc = ((rmod.CONFIG, tmod.CONFIG) if size == "CONFIG"
                  else (rmod.smoke_config(), tmod.smoke_config()))
        assert TCELLS.lm_param_flops(tc) == RCELLS.lm_param_flops(rc)


def _same_value(ref, port) -> bool:
    if isinstance(ref, type):                  # a dtype
        return port is {jnp.float32: torch.float32,
                        jnp.bfloat16: torch.bfloat16}[ref]
    return ref == port


def test_registry_has_the_reference_architectures():
    """The ten architectures, four shapes each, with the reference's
    arch fields (``opt_state_mode`` included), shapes and every field of
    the config the reference's config has (dtypes mapped, the kernel
    backend aside; the LM configs have exactly the reference's fields)."""
    assert list(TREG.ARCHS) == list(RREG.ARCHS)
    assert len(TREG.ARCHS) == 10
    for aid, ref in RREG.ARCHS.items():
        port = TREG.get_arch(aid)
        assert len(port.shapes) == 4
        for f in ("arch_id", "family", "source", "opt_state_mode"):
            assert getattr(port, f) == getattr(ref, f), (aid, f)
        assert [dataclasses.asdict(s) for s in port.shapes] == \
            [dataclasses.asdict(s) for s in ref.shapes], aid
        ref_fields = {f.name for f in dataclasses.fields(ref.config)}
        port_fields = {f.name for f in dataclasses.fields(port.config)}
        if ref.family == "lm":
            assert port_fields == ref_fields
            assert port.notes == ref.notes
        # a kernel backend is named per package ("xla" there, None =
        # the device default here); the rest must be equal
        for f in ref_fields & port_fields - {"backend"}:
            assert _same_value(getattr(ref.config, f),
                               getattr(port.config, f)), (aid, f)
    assert TREG.get_arch("arctic-480b").opt_state_mode == "int8"
    assert TREG.get_arch("grok-1-314b").opt_state_mode == "int8"


@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_smoke_configs_equal(name):
    rc = importlib.import_module(f"repro.configs.{name}").smoke_config()
    tc = importlib.import_module(f"repro_torch.configs.{name}").smoke_config()
    for f in dataclasses.fields(rc):
        assert _same_value(getattr(rc, f.name), getattr(tc, f.name)), f.name


@pytest.mark.parametrize("mb", [1, 4, 8, 16])
def test_lm_shapes(mb):
    assert [dataclasses.asdict(s) for s in TREG.lm_shapes(mb)] == \
        [dataclasses.asdict(s) for s in RREG.lm_shapes(mb)]
    long = TREG.lm_shapes(mb)[-1]
    assert long.name == "long_500k" and long.skip_reason


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tf32_only_around_the_score_products(dtype, monkeypatch):
    """TF32 is switched on around the score products of bfloat16
    operands only (exact there), never around P·V or in float32, and the
    process's setting is restored; bfloat16 products reduce in float32
    inside the model's entry points."""
    mm = torch.backends.cuda.matmul
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append((a.shape[-1], mm.allow_tf32,
                     mm.allow_bf16_reduced_precision_reduction))
        return real(a, b)

    monkeypatch.setattr(mm, "allow_tf32", False)
    monkeypatch.setattr(mm, "allow_bf16_reduced_precision_reduction", True)
    monkeypatch.setattr(torch, "matmul", spy)
    rc, tc = _configs("qwen3_14b", dtype)
    tp = TT.init(torch.Generator().manual_seed(0), tc, device="cpu")
    tokens = torch.zeros((1, 64), dtype=torch.long)
    with torch.inference_mode():
        TT.forward(tp, tokens, tc)
    hd, chunk = tc.head_dim, tc.attn_chunk
    scores = [s for s in seen if s[0] == hd]           # q · k: over hd
    pv = [s for s in seen if s[0] == chunk]            # p · v: over a chunk
    assert len(scores) == len(pv) == 2 * tc.n_layers
    assert all(t == (dtype == "bfloat16") for _, t, _ in scores)
    assert not any(t for _, t, _ in pv)
    assert not any(r for _, _, r in seen)
    assert mm.allow_tf32 is False
    assert mm.allow_bf16_reduced_precision_reduction is True
