"""The PyTorch package's decode attention on the CPU, against the JAX
package's flash-decode Pallas kernel (interpret mode) and its oracle.

On a CPU tensor `kernels.decode_attention` runs its plain version, the
function the CUDA kernel computes; these tests hold that function to the TPU
kernel at the reference's shapes (2e-4 at fp32, 3e-2 at bf16), prove that
the model's ring-plus-causal-mask decode attention is the kernel's
prefix-valid mask with valid_len = min(qpos + 1, ring), and pin what both
kernels return at valid_len == 0, a row the engine never builds. With
`return_lse=True` the port also returns each row's log-sum-exp, a row with
no valid key weighs nothing, and the outputs over cuts of S merge into the
output over the whole of it.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.configs import reduced  # noqa: E402
from repro_torch.core.batching.buckets import Request  # noqa: E402
from repro_torch.kernels import decode_attention as kda  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving.engine import EngineConfig, build_engine  # noqa: E402

torch.set_num_threads(1)

# (B, H, KH, D, S): the JAX package's test shapes, then head size 96 with one
# query head a KV head (phi-3-vision's MHA) and whisper's cross-attention
# over 1,500 encoder positions (MHA, D 64)
SHAPES = [(2, 8, 4, 64, 512), (1, 7, 7, 128, 300), (4, 16, 16, 64, 1024),
          (2, 8, 8, 96, 300), (2, 8, 8, 64, 1500)]
TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _inputs(shape, seed, valid=None):
    b, h, kh, d, s = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    vl = rng.integers(1, s + 1, (b,)).astype(np.int32) if valid is None \
        else np.asarray(valid, np.int32)
    return q, k, v, vl


def _torch(arrays, dtype):
    q, k, v, vl = arrays
    dt = getattr(torch, dtype)
    return (*(torch.from_numpy(a).to(dt) for a in (q, k, v)), torch.from_numpy(vl))


def _jax(arrays, dtype):
    q, k, v, vl = arrays
    dt = getattr(jnp, dtype)
    return (*(jnp.asarray(a, dt) for a in (q, k, v)), jnp.asarray(vl))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel_and_oracles(shape, dtype):
    arrays = _inputs(shape, seed=sum(shape))
    tq, tk, tv, tvl = _torch(arrays, dtype)
    got = kda.decode_attention_plain(tq, tk, tv, tvl)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    want = np.asarray(decode_attention_pallas(*_jax(arrays, dtype), interpret=True),
                      np.float32)
    tol = TOL[dtype]
    assert_allclose(got, want, rtol=tol, atol=tol)
    # both packages' oracles (fp32 results) agree with each
    port_ref = ref.decode_attention_ref(tq, tk, tv, tvl).numpy()
    assert_allclose(port_ref, np.asarray(jref.decode_attention_ref(*_jax(arrays, dtype))),
                    rtol=2e-4, atol=2e-4)
    assert_allclose(got, port_ref, rtol=tol, atol=tol)
    # the public entry on a CPU tensor is the plain version, no launch
    kernels.reset_launch_counts()
    assert torch.equal(ops.decode_attention(tq, tk, tv, tvl),
                       kda.decode_attention_plain(tq, tk, tv, tvl))
    assert kernels.launch_counts()["decode_attention"] == 0


def _ring_kpos(qpos, wc):
    """The model's former decode mask: slot t of a true-position ring holds
    the most recent position <= qpos congruent to t (mod wc), -1 if none."""
    t = torch.arange(wc)
    kpos = qpos[..., None] - torch.remainder(qpos[..., None] - t, wc)
    return torch.where(kpos >= 0, kpos, torch.full_like(kpos, -1))


@pytest.mark.parametrize("per_row", [True, False])
def test_ring_mask_is_the_kernels_prefix_mask(per_row):
    """attention_dense over the ring with the causal mask == the kernel's
    function with valid_len = min(qpos + 1, ring): wrapped rows (150, 1000),
    a fresh row (0) and rows inside the ring, GQA 32/4, D = 64, fp32."""
    wc, kh, g, d = 144, 4, 8, 64
    qpos = torch.tensor([0, 5, 143, 150, 1000]) if per_row else torch.tensor([150])
    b = 5
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((b, 1, kh * g, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, wc, kh, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, wc, kh, d)).astype(np.float32))
    if per_row:
        want = L.attention_dense(q, k, v, qpos[:, None], _ring_kpos(qpos, wc),
                                 causal=True, window=0)[:, 0]
        vl = torch.clamp(qpos + 1, max=wc)
    else:  # the shared ring of run-to-completion decode: one scalar position
        want = L.attention_dense(q, k, v, qpos, _ring_kpos(qpos[0], wc),
                                 causal=True, window=0)[:, 0]
        vl = torch.full((b,), min(int(qpos[0]) + 1, wc))
    got = kda.decode_attention_plain(q[:, 0], k, v, vl.to(torch.int32))
    assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [512, 300])
def test_zero_valid_length_gives_the_mean_of_v(s):
    """valid_len == 0: every score is -1e30, every position weighs 1, so the
    port returns the mean of V over its S positions. The Pallas kernel pads
    S to its 512-key block with zero keys and values that weigh 1 too: it
    returns sum(V) / 512, equal to the port's mean when S is a multiple of
    512 (the JAX oracle always averages over S)."""
    b, h, kh, d = 2, 8, 4, 64
    arrays = _inputs((b, h, kh, d, s), seed=s, valid=[0, s // 3])
    tq, tk, tv, tvl = _torch(arrays, "float32")
    got = kda.decode_attention_plain(tq, tk, tv, tvl).numpy()
    mean_v = np.repeat(arrays[2][0].mean(0), h // kh, axis=0)   # [H, D]
    assert_allclose(got[0], mean_v, rtol=1e-5, atol=1e-5)
    assert_allclose(got, np.asarray(jref.decode_attention_ref(*_jax(arrays, "float32"))),
                    rtol=2e-4, atol=2e-4)
    pallas = np.asarray(decode_attention_pallas(*_jax(arrays, "float32"), interpret=True))
    assert_allclose(pallas[1], got[1], rtol=2e-4, atol=2e-4)
    padded = -(-s // 512) * 512
    assert_allclose(pallas[0], mean_v * s / padded, rtol=1e-5, atol=1e-5)
    if s % 512 == 0:
        assert_allclose(pallas[0], got[0], rtol=1e-5, atol=1e-5)


def _masked_scores(arrays):
    """The kernel's scaled fp32 scores [B, KH, G, S] with positions at or
    past valid_len masked to -inf (numpy, float64)."""
    q, k, v, vl = (np.asarray(a, np.float64) if a.dtype != np.int32 else a for a in arrays)
    b, h, d = q.shape
    s_len, kh = k.shape[1], k.shape[2]
    sc = np.einsum("bkgd,bjkd->bkgj", q.reshape(b, kh, h // kh, d), k) / np.sqrt(d)
    valid = np.arange(s_len)[None] < vl[:, None]
    return np.where(valid[:, None, None], sc, -np.inf)


def _np_lse(sc):
    top = sc.max(-1, keepdims=True)
    top = np.where(np.isfinite(top), top, 0.0)
    with np.errstate(divide="ignore"):
        return (np.log(np.exp(sc - top).sum(-1)) + top[..., 0]).reshape(sc.shape[0], -1)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_lse_matches_the_oracle_and_numpy(shape):
    """return_lse=True: o is the JAX package's oracle (2e-4, fp32) and lse
    the log-sum-exp of the masked scaled scores (1e-5), per row and head."""
    arrays = _inputs(shape, seed=sum(shape) + 1)
    tq, tk, tv, tvl = _torch(arrays, "float32")
    o, lse = kda.decode_attention_plain(tq, tk, tv, tvl, return_lse=True)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    assert lse.shape == tq.shape[:2]
    assert_allclose(o.numpy(), np.asarray(jref.decode_attention_ref(*_jax(arrays, "float32"))),
                    rtol=2e-4, atol=2e-4)
    assert_allclose(lse.numpy(), _np_lse(_masked_scores(arrays)), rtol=1e-5, atol=1e-5)
    # without the lse, the call is the one it always was
    assert torch.equal(kda.decode_attention_plain(tq, tk, tv, tvl), ops.decode_attention(
        tq, tk, tv, tvl))
    o2, lse2 = ops.decode_attention(tq, tk, tv, tvl, return_lse=True)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_valid_length_with_lse_weighs_nothing(dtype):
    """With the lse, a row with no valid key gives o = 0 and lse = -inf (a
    rank's cut that holds none of the row's keys); the other rows keep
    their output."""
    arrays = _inputs((3, 8, 4, 64, 300), seed=5, valid=[0, 100, 0])
    tq, tk, tv, tvl = _torch(arrays, dtype)
    o, lse = kda.decode_attention_plain(tq, tk, tv, tvl, return_lse=True)
    assert o.dtype == tq.dtype
    assert torch.equal(o[[0, 2]], torch.zeros_like(o[[0, 2]]))
    assert bool(torch.isneginf(lse[[0, 2]]).all()) and bool(torch.isfinite(lse[1]).all())
    assert torch.equal(o[1], kda.decode_attention_plain(tq, tk, tv, tvl)[1])


@pytest.mark.parametrize("m", [2, 4, 8])
def test_merging_the_cuts_equals_the_whole(m):
    """The attention over S from m cuts of S slots [r L, (r + 1) L), each
    with its own valid prefix clamp(valid_len - r L, 0, L), merged by their
    log-sum-exp (M = max_r lse_r; o = sum_r exp(lse_r - M) o_r / sum_r
    exp(lse_r - M)) equals the attention over the whole S within 1e-5.
    Rows valid up to 1 and 65 leave most cuts without a valid key."""
    shape = (4, 16, 4, 64, 1024)
    arrays = _inputs(shape, seed=m, valid=[1, 65, 700, 1024])
    tq, tk, tv, tvl = _torch(arrays, "float32")
    whole = kda.decode_attention_plain(tq, tk, tv, tvl).numpy()
    n = shape[-1] // m
    os_, lses = [], []
    for r in range(m):
        vl = torch.clamp(tvl - r * n, 0, n).to(torch.int32)
        o, lse = kda.decode_attention_plain(tq, tk[:, r * n:(r + 1) * n].contiguous(),
                                            tv[:, r * n:(r + 1) * n].contiguous(), vl,
                                            return_lse=True)
        os_.append(o.numpy())
        lses.append(lse.numpy())
    lses = np.stack(lses)
    assert np.isneginf(lses[1:, 0]).all()            # row 0's key lies in cut 0 alone
    w = np.exp(lses - lses.max(0))
    merged = (w[..., None] * np.stack(os_)).sum(0) / w.sum(0)[..., None]
    assert_allclose(merged, whole, rtol=1e-5, atol=1e-5)


def test_engine_never_builds_a_zero_valid_length(monkeypatch):
    """Every decode step of the slot pool — live rows, free rows, mid-prefill
    rows of a chunked admission — hands the kernel valid_len >= 1, and each
    step launches it once per layer."""
    seen = []
    real = ops.decode_attention

    def recording(q, k, v, valid_len):
        seen.append(valid_len.clone())
        return real(q, k, v, valid_len)

    monkeypatch.setattr(lm.ops, "decode_attention", recording)
    cfg = dataclasses.replace(reduced("tinyllama-1.1b"), dtype="float32")
    eng = build_engine(cfg, ec=EngineConfig(
        continuous=True, max_slots=4, segment_len=4, max_new_tokens=6,
        max_prompt_len=64, chunk_lens=(8,)), device="cpu")
    eng.submit_many([Request(rid=i, arrival=0.0, length=float(n))
                     for i, n in enumerate((60, 3, 17, 9, 33, 2))])
    done = eng.run_until_idle()
    assert len(done) == 6 and all(len(r.payload) == 6 for r in done)
    assert len(seen) == cfg.n_layers * eng.stats["decode_steps"] > 0
    vl = torch.stack(seen)
    assert vl.dtype == torch.int32 and int(vl.min()) >= 1
    assert int(vl.max()) <= eng.pool_len


def test_every_head_size_the_wrapper_takes_is_compiled():
    """The wrapper takes D in HEAD_DIMS (96 included: phi-3-vision's), and
    each of the CUDA source's three entry points dispatches exactly those
    head sizes."""
    import re
    from pathlib import Path

    assert 96 in kda.HEAD_DIMS
    src = (Path(kda.__file__).parent / "csrc" / "decode_attention.cu").read_text()
    bodies = src.split('extern "C"')[1:]
    assert len(bodies) == 3
    for body in bodies:
        assert tuple(sorted(int(d) for d in re.findall(r"d == (\d+)", body))) == kda.HEAD_DIMS


def test_kernel_wrapper_refuses_cpu_tensors():
    tq, tk, tv, tvl = _torch(_inputs(SHAPES[0], seed=1), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        kda.decode_attention_kernel(tq, tk, tv, tvl)


def test_sliding_window_decode_is_refused():
    """Sliding-window decode is served now (the name is kept from when it
    was refused). Decode over a 16-slot window ring (rows at true positions
    3 and 40, the second wrapped twice): every layer calls the decode
    attention with
    valid_len = min(qpos + 1, ring), and its output there equals the JAX
    package's Pallas kernel (interpret mode) on the same inputs."""
    cfg = dataclasses.replace(reduced("tinyllama-1.1b"), dtype="float32",
                              sliding_window=16)
    pool = lm.alloc_slot_pool(cfg, 2, 48, torch.device("cpu"))
    assert pool["body"]["l0"]["mixer"]["k"].shape[2] == 16
    gen = torch.Generator().manual_seed(0)
    for leaf in pool["body"]["l0"]["mixer"].values():
        leaf.normal_(generator=gen)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu", "float32")
    seen = []
    real = ops.decode_attention

    def spy(q, k, v, valid_len):
        out = real(q, k, v, valid_len)
        seen.append((q.clone(), k.clone(), v.clone(), valid_len.clone(), out))
        return out

    ops.decode_attention = spy
    try:
        logits, _ = lm.decode(params, pool, torch.zeros(2, 1, dtype=torch.long), 50, cfg,
                              pos_offset=torch.tensor([47, 10]))
    finally:
        ops.decode_attention = real
    assert logits.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert len(seen) == cfg.n_layers
    for q, k, v, vl, out in seen:
        assert vl.tolist() == [4, 16]
        want = decode_attention_pallas(*(jnp.asarray(t.numpy()) for t in (q, k, v, vl)),
                                       interpret=True)
        assert_allclose(out.numpy(), np.asarray(want), rtol=TOL["float32"],
                        atol=TOL["float32"])