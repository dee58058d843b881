"""The port's SSM (Mamba2) pieces against the JAX package's, on the CPU.

The plain version of the CUDA ``ssd_scan`` kernel (on CPU tensors its
wrapper runs it) is held against JAX's ``ssd_scan`` op (the Pallas kernel
in interpret mode, its default) and against JAX's ``ssd_sequential``, at
rtol/atol 2e-4, the bar of ``tests/test_kernels.py``'s SSD tests (0.08
with bf16 inputs, its bf16 bar). The model pieces (``ssd_chunked``,
``ssd_sequential``, ``_causal_conv``, ``mamba2_forward``,
``mamba2_decode``) are held against JAX's at 1e-4 with JAX's parameters
carried across by ``interop.params_from_numpy``. The kernel itself is
held against the same plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan as jssd_scan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

SSD_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B=2, L=64, H=4, P=8, N=16):
    """The SSD operands as ``tests/test_kernels.py`` draws them, in f32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, L, H, P),
            rng.uniform(0.001, 0.1, (B, L, H)).astype(np.float32),
            -rng.uniform(0.5, 4.0, (H,)).astype(np.float32),
            f(B, L, N), f(B, L, N), f(H))


def _t(arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("L,chunk", [(64, 8), (64, 16), (64, 32), (64, 64),
                                     (40, 16), (40, 64)])
def test_ssd_plain_matches_jax_chunks(L, chunk):
    """The chunk sweep of the JAX kernel tests, a ragged L = 40 at chunk
    16 (the wrapper pads, the kernel masks past L) and L = 40 below the
    chunk (one chunk of L rows, as the JAX op takes it)."""
    ins = _inputs(L + chunk, L=L)
    got = ssd_ops.ssd_scan(*_t(ins), chunk=chunk)
    assert got[0].shape == (2, L, 4, 8) and got[1].shape == (2, 4, 16, 8)
    assert got[1].dtype == torch.float32
    _close(got, jssm.ssd_sequential(*ins), SSD_TOL)
    _close(got, jssd_scan(*ins, chunk=chunk), SSD_TOL)


@pytest.mark.parametrize("P,N", [(8, 8), (16, 32), (64, 16)])
def test_ssd_plain_matches_jax_dims(P, N):
    ins = _inputs(P + N, P=P, N=N)
    got = ssd_ops.ssd_scan(*_t(ins), chunk=16)
    _close(got, jssm.ssd_sequential(*ins), SSD_TOL)
    _close(got, jssd_scan(*ins, chunk=16), SSD_TOL)


def test_ssd_plain_bf16_inputs():
    """x, B and C in bf16: y comes back in bf16 within the JAX kernel
    tests' bf16 bar of the f32 sequential scan on the same values."""
    x, dt, A, Bi, Ci, D = _inputs(7)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    jins = (bf(x), dt, A, bf(Bi), bf(Ci), D)
    tins = [torch.as_tensor(np.asarray(a, np.float32)) for a in jins]
    for i in (0, 3, 4):
        tins[i] = tins[i].to(torch.bfloat16)
    y, h = ssd_ops.ssd_scan(*tins, chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y_ref, _ = jssm.ssd_sequential(*jins)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_ref, np.float32),
                               rtol=0.08, atol=0.08)


def test_ssd_chunked_and_sequential_match_jax():
    """The model's two plain routes, from a nonzero h0, against JAX's."""
    x, dt, A, Bi, Ci, D = _inputs(11, L=48)
    h0 = np.random.default_rng(12).standard_normal(
        (2, 4, 16, 8)).astype(np.float32)
    ins = (x, dt, A, Bi, Ci, D)
    want_seq = jssm.ssd_sequential(*ins, h0=h0)
    _close(ssm.ssd_sequential(*_t(ins), h0=torch.as_tensor(h0)), want_seq,
           TOL)
    for chunk in (8, 16, 48):
        got = ssm.ssd_chunked(*_t(ins), chunk, h0=torch.as_tensor(h0))
        _close(got, jssm.ssd_chunked(*ins, chunk, h0=h0), TOL)
        _close(got, want_seq, SSD_TOL)


def test_ssd_chunked_masks_before_exp():
    """A decay large enough that e^{cum_i - cum_j} above the diagonal is
    inf: the masked entries are selected away, so y stays finite and
    equals the sequential scan."""
    x, dt, A, Bi, Ci, D = _t(_inputs(13, L=32))
    A = torch.full_like(A, -400.0)
    y, h = ssm.ssd_chunked(x, dt * 10, A, Bi, Ci, D, 32)
    ys, hs = ssm.ssd_sequential(x, dt * 10, A, Bi, Ci, D)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    torch.testing.assert_close(y, ys, **TOL)
    torch.testing.assert_close(h, hs, **TOL)


def _mamba_pair(seed=0):
    jcfg = jconfigs.get_smoke("mamba2-370m")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jax.tree.map(np.asarray, jssm.init_mamba2(jax.random.PRNGKey(seed),
                                                   jcfg))
    return jcfg, jp, cfg, interop.params_from_numpy(jp, cfg, "cpu")


def test_causal_conv_matches_jax():
    _, jp, _, p = _mamba_pair(1)
    rng = np.random.default_rng(1)
    xBC = rng.standard_normal((2, 9, jp["conv_w"].shape[1])).astype(
        np.float32)
    got = ssm._causal_conv(torch.as_tensor(xBC), p["conv_w"], p["conv_b"])
    want = jssm._causal_conv(xBC, jp["conv_w"], jp["conv_b"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["cuda", "chunked", "naive"])
def test_mamba2_forward_matches_jax(impl):
    """A full Mamba2 block with its decode state (L = 21: not a multiple of
    the 16-row chunk); ``cuda`` runs the kernel's plain version here."""
    jcfg, jp, cfg, p = _mamba_pair(2)
    x = np.random.default_rng(2).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    jy, jst = jssm.mamba2_forward(jp, jcfg, x, return_state=True)
    y, st = ssm.mamba2_forward(p, cfg, torch.as_tensor(x), return_state=True,
                               impl=impl)
    _close((y, st.conv, st.h), (jy, jst.conv, jst.h), TOL)
    y2 = ssm.mamba2_forward(p, cfg, torch.as_tensor(x), impl=impl)
    torch.testing.assert_close(y2, y, rtol=0, atol=0)


def test_mamba2_decode_matches_jax():
    """Three recurrent steps from the state a prefill left."""
    jcfg, jp, cfg, p = _mamba_pair(3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 17, cfg.d_model)).astype(np.float32)
    _, jst = jssm.mamba2_forward(jp, jcfg, x, return_state=True)
    _, st = ssm.mamba2_forward(p, cfg, torch.as_tensor(x), return_state=True)
    for _ in range(3):
        tok = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jst = jssm.mamba2_decode(jp, jcfg, tok, jst)
        conv0 = st.conv.clone()
        out, st_new = ssm.mamba2_decode(p, cfg, torch.as_tensor(tok), st)
        assert torch.equal(st.conv, conv0)            # input left alone
        st = st_new
        _close((out, st.conv, st.h), (jout, jst.conv, jst.h), TOL)


def test_init_mamba2_shapes_and_scales():
    """Not bitwise (torch.Generator is not threefry): JAX's tree, shapes
    and distributions, stacked over the layer axis; the per-head vectors
    stay f32 when the rest is stored in bf16."""
    cfg = configs.get_config("mamba2-370m")
    jp = jax.eval_shape(lambda k: jssm.init_mamba2(k, cfg),
                        jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    p = ssm.init_mamba2(gen, cfg, device="cpu", lead=(2,))
    assert set(p) == set(jp)
    for k, v in p.items():
        assert tuple(v.shape) == (2,) + tuple(jp[k].shape), k
    H = cfg.ssm_heads
    A = -torch.exp(p["A_log"])
    assert bool(((A <= -1.0) & (A >= -16.0)).all())
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all())
    assert abs(p["wz"].std() * np.sqrt(cfg.d_model) - 1) < 0.02
    assert abs(p["conv_w"].std() * 2 - 1) < 0.05
    assert torch.equal(p["D"], torch.ones(2, H))
    bf = ssm.init_mamba2(gen, cfg, device="cpu", dtype=torch.bfloat16)
    assert bf["wx"].dtype == bf["conv_w"].dtype == torch.bfloat16
    assert all(bf[k].dtype == torch.float32
               for k in ("A_log", "dt_bias", "D", "norm_w"))


def test_ssd_operand_checks():
    """What the CUDA wrapper refuses before a launch (checked here on CPU
    tensors; the device check is the same). Views of one projection with
    unit-stride rows pass."""
    B, L, H, P, N = 1, 8, 2, 4, 16
    f = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)  # noqa: E731
    xBC = f(B, L, H * P + 2 * N)
    xs, Bi, Ci = torch.split(xBC, [H * P, N, N], dim=-1)
    ok = dict(x=xs.reshape(B, L, H, P), dt=f(B, L, H), A=f(H), B_in=Bi,
              C_in=Ci, D_skip=f(H))
    checks.ssd_operands("t", 16, **ok)

    def bad(err, chunk=16, **kw):
        with pytest.raises(err):
            checks.ssd_operands("t", chunk, **{**ok, **kw})

    bad(ValueError, chunk=256)                                  # chunk
    bad(ValueError, B_in=f(B, L, 160), C_in=f(B, L, 160))       # N > 128
    bad(TypeError, x=f(B, L, H, P, dt=torch.float16))           # dtype
    bad(TypeError, B_in=Bi.to(torch.bfloat16))                  # mixed
    bad(TypeError, dt=f(B, L, H, dt=torch.bfloat16))            # dt f32
    bad(ValueError, dt=f(B, L + 1, H))                          # shape
    bad(ValueError, A=f(H + 1))
    bad(ValueError, x=f(B, L, P, H).transpose(2, 3))            # rows
    bad(ValueError, C_in=f(B, N, L).transpose(1, 2))
    bad(ValueError, D_skip=f(2 * H)[::2])                       # contiguous
