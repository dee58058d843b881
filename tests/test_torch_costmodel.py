"""The port's cost model and roofline against the JAX package's.

Twins of ``tests/test_launch.py``'s cost-model tests (exact matmul FLOPs,
a loop's trip count, the recompute of a checkpointed region, the walker
against 6·N·D), then each family at SMOKE (dense, ssm, hybrid, moe, vlm,
audio): ``prefill_forward``, ``decode_step(impl="einsum")`` and the train
step traced on ``meta`` tensors against JAX's ``fn_cost`` of the same
call on ``ShapeDtypeStruct``s. The matmul FLOPs equal JAX's
``dot_general`` FLOPs, but for the SSM families' train step, where JAX's
layer scan transposes every chunk alike and so also differentiates the
zero initial state and the unused final state, which torch's autograd
prunes: the difference is that work exactly. The total FLOPs agree within
2% (the port's elementwise ops are not JAX's one for one: a softmax is one
op here and five there) and the bytes within 1.5x either way.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs.shapes import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.launch import costmodel as jcm  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro.training import train_state_init as jtrain_state_init  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import INPUT_SHAPES  # noqa: E402
from repro_torch.launch import costmodel, roofline  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.training import (  # noqa: E402
    make_train_step, train_state_init,
)

SDS = jax.ShapeDtypeStruct
META = torch.device("meta")
FAMILIES = {"dense": "olmo-1b", "ssm": "mamba2-370m", "hybrid": "zamba2-2.7b",
            "moe": "dbrx-132b", "vlm": "phi-3-vision-4.2b",
            "audio": "whisper-medium"}
B, S = 2, 64


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_dot_flops_exact():
    _, c = costmodel.trace_cost(lambda a, b: a @ b, _meta(64, 128),
                                _meta(128, 32))
    assert c.dot_flops == c.flops == 2 * 64 * 128 * 32
    assert c.flop_counter == 2 * 64 * 128 * 32
    assert c.hbm_bytes == 4 * 2 * (64 * 128 + 128 * 32 + 64 * 32)


@pytest.mark.parametrize("L", [2, 8])
def test_loop_counts_every_trip(L):
    def f(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x

    flops, _ = costmodel.fn_cost(f, _meta(32, 32), _meta(L, 32, 32))
    assert flops == L * 2 * 32 * 32 * 32


def test_remat_recompute_counted():
    def f(x, w):
        return torch.utils.checkpoint.checkpoint(
            lambda x: torch.tanh(x @ w), x, use_reentrant=False).sum()

    def grad(x, w):
        return torch.autograd.grad(f(x, w), w)

    x = _meta(32, 32)
    w = _meta(32, 32).requires_grad_()
    fwd, _ = costmodel.fn_cost(f, x, w)
    g, _ = costmodel.fn_cost(grad, x, w)
    assert g > 2.0 * fwd          # the backward's two products + recompute


def test_train_step_flops_vs_analytic():
    cfg = ModelConfig(name="t", arch_type="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
                      dtype="float32")
    state = train_state_init(init_model(cfg, device="meta"))
    batch = {"tokens": _meta(4, 32, dtype=torch.int32),
             "labels": _meta(4, 32, dtype=torch.int32)}
    flops, _ = costmodel.fn_cost(make_train_step(cfg, remat=False), state,
                                 batch)
    ratio = flops / (6.0 * cfg.active_params() * 4 * 32)
    assert 0.5 < ratio < 3.0, ratio


def test_roofline_terms_at_h100_peaks():
    t = roofline.roofline_terms(989e12, 3.35e12, 450e9)
    for k in ("compute_s", "memory_s", "collective_s"):
        assert abs(t[k] - 1.0) < 1e-12
    t = roofline.roofline_terms(1e12, 1e9, 0.0)
    assert t["dominant"] == "compute_s" and t["bound_s"] == 1e12 / 989e12
    assert roofline.roofline_terms(1.0, 3.35e12, 0.0)["dominant"] == "memory_s"


def test_model_flops_match_jax():
    for arch in configs.ARCH_IDS:
        for name in INPUT_SHAPES:
            assert roofline.model_flops(configs.get_config(arch),
                                        INPUT_SHAPES[name]) == \
                jrl.model_flops(jconfigs.get_config(arch),
                                JSHAPES[name]), (arch, name)


def _jax_cost(fn, *args):
    """JAX's ``fn_cost`` (flops, bytes) and its ``dot_general`` FLOPs, from
    one trace."""
    closed = jax.make_jaxpr(fn)(*args)
    flops, nbytes = jcm.jaxpr_cost(closed.jaxpr)
    nbytes += sum(jcm._aval_bytes(v.aval) for v in closed.jaxpr.invars)
    nbytes += sum(jcm._aval_bytes(v.aval) for v in closed.jaxpr.outvars)
    dots = 0.0

    def walk(jaxpr, mult):
        nonlocal dots
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                dots += mult * jcm._dot_flops(eqn)
            elif eqn.primitive.name == "scan":
                walk(eqn.params["jaxpr"].jaxpr, mult * eqn.params["length"])
            else:
                for sub in jcm._iter_sub_jaxprs(eqn.params):
                    walk(sub, mult)

    walk(closed.jaxpr, 1)
    return flops, nbytes, dots


def _inputs(cfg):
    """(JAX specs, port specs) of the token batch."""
    j = {"tokens": SDS((B, S), jnp.int32)}
    t = {"tokens": _meta(B, S, dtype=torch.int32)}
    if cfg.is_encdec:
        shape = (B, cfg.encoder_seq, cfg.frontend_dim)
        j["encoder_frames"], t["encoder_frames"] = SDS(shape, jnp.float32), \
            _meta(*shape)
    elif cfg.frontend_tokens:
        shape = (B, cfg.frontend_tokens, cfg.frontend_dim)
        j["frontend"], t["frontend"] = SDS(shape, jnp.float32), _meta(*shape)
    return j, t


@functools.lru_cache(maxsize=None)
def _costs(family, step):
    """(JAX's (flops, bytes, dots), the port's Cost) of one step."""
    jcfg = jconfigs.get_smoke(FAMILIES[family])
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jax.eval_shape(lambda: jt.init_model(jax.random.PRNGKey(0), jcfg))
    p = init_model(cfg, device="meta")
    jin, tin = _inputs(cfg)
    if step == "prefill":
        want = _jax_cost(lambda p_, b: jt.prefill_forward(
            p_, jcfg, b.pop("tokens"), **b), jp, jin)
        _, got = costmodel.trace_cost(lambda p_, b: tt.prefill_forward(
            p_, cfg, b["tokens"], impl="chunked",
            **{k: v for k, v in b.items() if k != "tokens"}), p, tin)
    elif step == "decode":
        enc = cfg.encoder_seq if cfg.is_encdec else 0
        jc = jax.eval_shape(lambda: jt.init_caches(jcfg, B, S, enc_seq=enc))
        want = _jax_cost(lambda p_, t_, c_: jt.decode_step(
            p_, jcfg, t_, c_, impl="einsum"), jp, SDS((B, 1), jnp.int32), jc)
        tc = tt.init_caches(cfg, B, S, enc_seq=enc, device="meta")
        _, got = costmodel.trace_cost(lambda p_, t_, c_: tt.decode_step(
            p_, cfg, t_, c_, impl="einsum"), p, _meta(B, 1, dtype=torch.int32),
            tc._replace(pos=S - 1))
    else:
        jin["labels"], tin["labels"] = jin["tokens"], tin["tokens"]
        want = _jax_cost(jmake_train_step(jcfg, remat=True),
                         jax.eval_shape(jtrain_state_init, jp), jin)
        _, got = costmodel.trace_cost(make_train_step(cfg, remat=True),
                                      train_state_init(p), tin)
    return want, got


def _pruned_scan_work(cfg) -> float:
    """The matmul FLOPs of the SSD chunk scan's backward that JAX's scan
    does and torch's autograd prunes, per Mamba2 layer: the first chunk's
    product with the zero initial state (its gradient, one (N, P)
    contraction) and the last chunk's state update, whose output nothing
    reads (the gradients of its contraction and of its outer product)."""
    Q, H, P, N = cfg.ssm_chunk, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    per_layer = 3 * (2 * B * Q * H * P * N) + 2 * (2 * B * Q * H * P)
    return cfg.num_layers * per_layer


@pytest.mark.parametrize("step", ["prefill", "decode", "train"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_costs_match_jax(family, step):
    (jflops, jbytes, jdots), got = _costs(family, step)
    cfg = configs.get_smoke(FAMILIES[family])
    want_dots = jdots
    if step == "train" and cfg.arch_type in ("ssm", "hybrid"):
        want_dots -= _pruned_scan_work(cfg)
    assert got.dot_flops == want_dots
    assert got.flop_counter == got.dot_flops
    assert abs(got.flops / jflops - 1) <= 0.02, got.flops / jflops
    assert 1 / 1.5 <= got.hbm_bytes / jbytes <= 1.5, got.hbm_bytes / jbytes
