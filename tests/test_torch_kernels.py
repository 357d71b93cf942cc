"""The port's kernels (fingerprint, sliding-window attention, RG-LRU scan,
chunkwise mLSTM), through their plain versions on the CPU, against the JAX
package: the Pallas kernels in interpret mode and the oracles of
``repro.kernels.ref``.  Inputs are made with numpy from a seed and handed to
both frameworks.  The CUDA kernels themselves run only on the card and are
checked there by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import crypto as jcrypto
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.runtime import attest as jattest

from repro_torch.bridge import tensor_from_numpy
from repro_torch.core import crypto as tcrypto
from repro_torch.kernels import cuda, ops, ref, rglru
from repro_torch.kernels.mlstm import mlstm_cuda, mlstm_plain
from repro_torch.kernels.rglru import rglru_cuda, rglru_plain
from repro_torch.kernels.swa import swa_plain
from repro_torch.runtime import attest

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

RGLRU_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_kernels.py's
MLSTM_TOL = {jnp.float32: dict(rtol=2e-4, atol=2e-4),   # tests/test_kernels.py's
             jnp.bfloat16: dict(rtol=5e-2, atol=5e-2)}


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _words_np(x: np.ndarray) -> np.ndarray:
    """The uint32 words that the digest hashes: raw 16-bit words of
    bf16/f16, raw 32-bit words of f32/int32/uint32."""
    if x.dtype.itemsize == 2:
        return x.view(np.uint16).astype(np.uint32)
    return x.view(np.uint32)


def _fp_input(n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * 100
    if dtype == "uint32":
        return rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    return x.astype(dtype)


@pytest.mark.parametrize("n,dtype", [
    (100, "float32"), (4096, "float32"), (5000, "bfloat16"), (12345, "int32"),
    (777, "float16"), (3000, "uint32"), (1, "bfloat16"),
])
def test_fingerprint_plain_matches_jax_bit_for_bit(n, dtype):
    x = _fp_input(n, dtype, seed=n)
    t = tensor_from_numpy(x)
    got = ops.fingerprint(t)
    w = _words_np(x)
    want = {
        "pallas": int(jops.fingerprint(jnp.asarray(x))[0]),
        "ref": int(jref.fingerprint_ref(jnp.asarray(w))[0]),
        "attest": int(jattest.fingerprint_array(jnp.asarray(x))),
        "attest_words_np": jcrypto.attest_words_np(w),
        "port ref": ref.fingerprint_ref(torch.from_numpy(w.astype(np.int64))),
        "port attest": attest.fingerprint_array(t),
    }
    assert want == {k: got for k in want}
    # one changed word changes the digest
    t2 = t.clone()
    t2.view(torch.int16 if t.element_size() == 2 else torch.int32)[n // 2] ^= 1
    assert ops.fingerprint(t2) != got


def test_attest_batch_numpy_backend_matches_reference():
    rng = np.random.default_rng(3)
    arrays = [rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
              for n in (0, 1, 4096, 5000)]
    assert tcrypto.attest_batch(arrays) == jcrypto.attest_batch(arrays)
    assert tcrypto.attest_batch(arrays) == [
        ops.fingerprint(torch.from_numpy(a.view(np.int32))) for a in arrays]


def _swa_inputs(B, S, H, KV, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    return jx, [tensor_from_numpy(np.asarray(a)) for a in jx]


def _tol(dtype):
    # bf16 outputs round to 8 bits of mantissa; fp32 differs only in the
    # order of the sums
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,dh,w", [
    (1, 32, 2, 2, 8, 8),
    (2, 64, 4, 2, 16, 16),
    (1, 96, 4, 1, 32, 32),    # S not a multiple of 2w — exercises padding
    (2, 128, 8, 4, 16, 32),
    (1, 72, 4, 1, 16, 16),    # KV = 1, G = 4, ragged last chunk
])
def test_swa_plain_matches_pallas(B, S, H, KV, dh, w, dtype):
    (jq, jk, jv), (q, k, v) = _swa_inputs(B, S, H, KV, dh, dtype, seed=S + H)
    want = jops.sliding_window_attention(jq, jk, jv, window=w)
    got = ops.sliding_window_attention(q, k, v, w)
    assert got.dtype == q.dtype and got.shape == (B, S, H, dh)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("P,S,dh,w", [(3, 40, 8, 8), (2, 33, 16, 16)])
def test_swa_ref_matches_jax_ref_and_plain(P, S, dh, w):
    (jq, jk, jv), (q, k, v) = _swa_inputs(1, S, P, P, dh, jnp.float32, seed=P)
    planes = [x[0].transpose(0, 1) for x in (q, k, v)]          # (P, S, dh)
    got = ref.swa_ref(*planes, window=w)
    want = jref.swa_ref(*(jnp.transpose(x[0], (1, 0, 2)) for x in (jq, jk, jv)),
                        window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    plain = swa_plain(q, k, v, w)[0].transpose(0, 1)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_wrappers_refuse_devices_without_a_kernel_or_plain_path():
    with pytest.raises(ValueError):
        ops.fingerprint(torch.zeros(4, device="meta"))
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError):
        ops.sliding_window_attention(q, q.to("meta"), q, 4)


@pytest.mark.parametrize("B,S,W,tb", [
    (1, 32, 16, 8),
    (2, 128, 64, 32),
    (1, 100, 32, 25),
    (3, 64, 8, 64),
])
def test_rglru_plain_matches_pallas_and_ref(B, S, W, tb):
    rng = np.random.default_rng(S + W)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, S, W))))).astype(np.float32)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    got = ops.rglru_scan(_t(a), _t(x))
    assert got.dtype == torch.float32 and got.shape == (B, S, W)
    pallas = jops.rglru_scan(jnp.asarray(a), jnp.asarray(x), t_blk=tb)
    jax_ref = jref.rglru_ref(jnp.asarray(a), jnp.asarray(x))
    for want in (pallas, jax_ref):
        np.testing.assert_allclose(got.numpy(), _np(want), **RGLRU_TOL)
    np.testing.assert_allclose(ref.rglru_ref(_t(a), _t(x)).numpy(),
                               _np(jax_ref), **RGLRU_TOL)
    assert torch.equal(rglru_plain(_t(a), _t(x)), got)


def _mlstm_inputs(B, S, H, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, dh)).astype(np.float32) * s
            for s in (0.5, 0.5, 1.0)]
    it = rng.standard_normal((B, S, H)).astype(np.float32)
    ft = rng.standard_normal((B, S, H)).astype(np.float32) + 2.0
    jqkv = [jnp.asarray(a).astype(dtype) for a in arrs]
    tqkv = [tensor_from_numpy(np.asarray(a)) for a in jqkv]
    return jqkv, tqkv, (it, ft)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,S,H,dh,chunk", [
    (1, 32, 2, 8, 8),
    (2, 64, 2, 16, 16),
    (1, 64, 4, 32, 32),
    (1, 48, 2, 16, 16),       # padded tail chunk
])
def test_mlstm_chunkwise_matches_pallas_and_sequential_oracle(
        B, S, H, dh, chunk, dtype):
    (jq, jk, jv), (q, k, v), (it, ft) = _mlstm_inputs(B, S, H, dh, dtype,
                                                      seed=S + dh)
    got = ops.mlstm_chunkwise(q, k, v, _t(it), _t(ft), chunk=chunk)
    assert got.dtype == q.dtype and got.shape == (B, S, H, dh)
    want = jops.mlstm_chunkwise(jq, jk, jv, jnp.asarray(it), jnp.asarray(ft),
                                chunk=chunk)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **MLSTM_TOL[dtype])

    def planes(x):      # (B, S, H, d) -> (B·H, S, d)
        return x.transpose(1, 2).reshape(B * H, S, -1)

    seq = ref.mlstm_ref(*(planes(x.float()) for x in (q, k, v)),
                        planes(_t(it)[..., None]), planes(_t(ft)[..., None]))
    jseq = jref.mlstm_ref(*(jnp.asarray(planes(x.float()).numpy())
                            for x in (q, k, v)),
                          jnp.asarray(planes(_t(it)[..., None]).numpy()),
                          jnp.asarray(planes(_t(ft)[..., None]).numpy()))
    np.testing.assert_allclose(seq.numpy(), _np(jseq), **MLSTM_TOL[jnp.float32])
    np.testing.assert_allclose(
        planes(got.float()).numpy(), seq.numpy(), **MLSTM_TOL[dtype])


def test_wrappers_refuse_mixed_devices_and_kernels_refuse_cpu_tensors():
    a = torch.rand(1, 8, 4)
    with pytest.raises(ValueError):
        ops.rglru_scan(a, a.to("meta"))
    with pytest.raises(ValueError):
        rglru_cuda(a, a)
    q = torch.zeros(1, 8, 2, 4)
    g = torch.zeros(1, 8, 2)
    with pytest.raises(ValueError):
        ops.mlstm_chunkwise_state(q, q, q.to("meta"), g, g, 8)
    with pytest.raises(ValueError):
        mlstm_cuda(q, q, q, g, g, 8)
    with pytest.raises(ValueError):
        mlstm_plain(q, q, q, g, g, 3)       # S is not a multiple of chunk


# ---------------------------------------------------------------------------
# The kernels' arithmetic, emulated in PyTorch on the CPU and held against
# the Pallas kernels in interpret mode.  The emulations follow the CUDA
# sources (csrc/swa.cu, csrc/mlstm.cu, csrc/rglru.cu) step by step: which
# tiles are visited, what is computed from the gates alone, where an fp32
# operand enters a 16-bit product as a hi/lo pair, in which order the RG-LRU
# scan's segments are combined.  The CUDA kernels themselves are held
# against the plain versions on the card by chip_smoke.py; nothing here
# notices when a .cu file drifts from its emulation, so a change to the
# arithmetic of csrc/swa.cu, csrc/mlstm.cu or csrc/rglru.cu changes the
# emulation below in the same commit.
# ---------------------------------------------------------------------------
NEG_INF_F = -1e30


def _split(x, half=torch.bfloat16):
    """An fp32 operand as the kernels feed it to the tensor cores: hi =
    half(x), lo = half(x - hi), returned as fp32 values."""
    hi = x.to(half).float()
    return hi, (x - hi).to(half).float()


def _swa_tile_walk(q, k, v, w, tile=64):
    """csrc/swa.cu's swa_tc_kernel: a block of ``tile`` query rows walks the
    key tiles that meet its band, masking only edge tiles.  Two warps share
    the rows and take the first and second half of every tile's keys, each
    with its own online softmax in log2 units (fp32) and P·V with P as a
    hi/lo pair; at the end the second warp's state merges into the first's.
    Returns the output and the number of key tiles visited.  Mirrors
    ``swa_tc_kernel`` as of commit 10cbea7."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    half = torch.bfloat16 if q.dtype == torch.float32 else q.dtype
    sl2 = dh ** -0.5 * 1.4426950408889634
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(G, dim=2) for x in (k, v))
    out = torch.empty(B, S, H, dh)
    visited = 0
    for q0 in range(0, S, tile):
        rows = torch.arange(q0, min(q0 + tile, S))
        shape = (B, len(rows), H)
        # (m, l, acc) of the two key halves
        state = [[torch.full(shape, NEG_INF_F), torch.zeros(shape),
                  torch.zeros(*shape, dh)] for _ in range(2)]
        kt0 = max(0, q0 - w + 1) // tile
        kt1 = (min(q0 + tile, S) - 1) // tile
        for kt in range(kt0, kt1 + 1):
            visited += 1
            for part, (m, l, acc) in enumerate(state):
                k0 = kt * tile + part * tile // 2
                if k0 >= S:
                    continue
                keys = torch.arange(k0, min(k0 + tile // 2, S))
                s = torch.einsum("brhd,bkhd->brhk", qf[:, rows], kf[:, keys])
                delta = rows[:, None] - keys[None, :]
                band = ((delta >= 0) & (delta < w))[None, :, None, :]
                s = torch.where(band, s * sl2, NEG_INF_F)
                mn = torch.maximum(m, s.amax(-1))
                p = torch.where(band, torch.exp2(s - mn[..., None]), 0.0)
                alpha = torch.exp2(m - mn)
                hi, lo = _split(p, half)
                state[part] = [
                    mn, l * alpha + p.sum(-1),
                    acc * alpha[..., None]
                    + torch.einsum("brhk,bkhd->brhd", hi, vf[:, keys])
                    + torch.einsum("brhk,bkhd->brhd", lo, vf[:, keys])]
        (ma, la, acca), (mb, lb, accb) = state
        mx = torch.maximum(ma, mb)
        fa, fb = torch.exp2(ma - mx), torch.exp2(mb - mx)
        den = torch.clamp(la * fa + lb * fb, min=1e-30)
        out[:, rows] = ((acca * fa[..., None] + accb * fb[..., None])
                        / den[..., None])
    return out.to(q.dtype), visited


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,dh,w,tile", [
    (1, 200, 4, 1, 32, 48, 64),     # GQA 4:1, ragged S, tiles skipped
    (2, 150, 4, 2, 16, 64, 64),     # ragged S, w = tile
    (1, 130, 2, 2, 16, 512, 64),    # window longer than S
    (1, 72, 4, 1, 16, 16, 16),      # small tiles, many skipped
])
def test_swa_tile_walk_matches_pallas(B, S, H, KV, dh, w, tile, dtype):
    (jq, jk, jv), (q, k, v) = _swa_inputs(B, S, H, KV, dh, dtype, seed=S + w)
    got, visited = _swa_tile_walk(q, k, v, w, tile)
    want = jops.sliding_window_attention(jq, jk, jv, window=w)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))
    n_tiles = -(-S // tile)
    all_pairs = n_tiles * (n_tiles + 1) // 2     # every causal tile pair
    assert (visited < all_pairs) == (S > w + tile)


def _mlstm_two_pass(q, k, v, it, ft, c):
    """csrc/mlstm.cu's bf16 path.  State pass: from the gates alone, chunk by
    chunk, the stabiliser chain m, dec and w_s; the state entering each chunk
    (C_in, n_in, m_in); C <- dec C + (k w)^T V with k w as a hi/lo pair.
    Output pass, every chunk at once: row stabilisers from a prefix max of
    i_s - csum_s, num = sq (q C_in) + W V with C_in and W as hi/lo pairs,
    h = num / max(|rowsum W + sq q.n_in|, 1).  Mirrors
    ``mlstm_state_kernel`` and ``mlstm_out_kernel`` as of commit 10cbea7."""
    B, S, H, dh = q.shape
    nc = S // c
    qf, kf, vf = (x.float().reshape(B, nc, c, H, dh) for x in (q, k, v))
    ig = it.float().reshape(B, nc, c, H)
    csum = torch.cumsum(F.logsigmoid(ft.float()).reshape(B, nc, c, H), dim=2)
    tot = csum[:, :, -1]                                      # (B, nc, H)

    C = torch.zeros(B, H, dh, dh)
    n = torch.zeros(B, H, dh)
    m = torch.full((B, H), NEG_INF_F)
    C_in, n_in, m_in = [], [], []
    for j in range(nc):
        C_in.append(C)
        n_in.append(n)
        m_in.append(m)
        a_end = (tot[:, j, None] - csum[:, j]) + ig[:, j]     # (B, c, H)
        m_next = torch.maximum(tot[:, j] + m, a_end.amax(dim=1))
        dec = torch.exp((tot[:, j] + m) - m_next)
        w_s = torch.exp(a_end - m_next[:, None])
        hi, lo = _split(kf[:, j] * w_s[..., None])
        C = (C * dec[..., None, None]
             + torch.einsum("bshd,bshe->bhde", hi, vf[:, j])
             + torch.einsum("bshd,bshe->bhde", lo, vf[:, j]))
        n = n * dec[..., None] + torch.einsum("bsh,bshd->bhd", w_s, kf[:, j])
        m = m_next
    C_in, n_in, m_in = (torch.stack(x, dim=1) for x in (C_in, n_in, m_in))

    pm = torch.cummax(ig - csum, dim=2).values
    b = csum + m_in[:, :, None]                               # (B, nc, c, H)
    m_row = torch.maximum(csum + pm, b)
    sq = torch.exp(b - m_row)
    hi, lo = _split(C_in)
    inter = (torch.einsum("bjthd,bjhde->bjthe", qf, hi)
             + torch.einsum("bjthd,bjhde->bjthe", qf, lo)) * sq[..., None]
    scores = torch.einsum("bjthd,bjshd->bjtsh", qf, kf)
    a = (csum[:, :, :, None] - csum[:, :, None]) + ig[:, :, None]
    causal = torch.ones(c, c, dtype=torch.bool).tril()[None, None, :, :, None]
    W = torch.where(causal, scores * torch.exp(a - m_row[:, :, :, None]), 0.0)
    hi, lo = _split(W)
    num = (inter + torch.einsum("bjtsh,bjshd->bjthd", hi, vf)
           + torch.einsum("bjtsh,bjshd->bjthd", lo, vf))
    n_inter = torch.einsum("bjthd,bjhd->bjth", qf, n_in) * sq
    den = torch.clamp((W.sum(dim=3) + n_inter).abs(), min=1.0)
    h = (num / den[..., None]).reshape(B, S, H, dh)
    return h.to(q.dtype), (C, n, m)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,S,H,dh,chunk", [
    (1, 32, 2, 16, 32),       # one chunk
    (2, 64, 2, 16, 32),       # two chunks
    (1, 128, 2, 32, 32),      # four chunks
    (1, 40, 2, 16, 16),       # padded tail: 40 -> 48, three chunks
])
def test_mlstm_two_pass_matches_pallas_and_plain_state(B, S, H, dh, chunk,
                                                       dtype):
    (jq, jk, jv), (q, k, v), (it, ft) = _mlstm_inputs(B, S, H, dh, dtype,
                                                      seed=S + chunk)
    c = min(chunk, S)
    pad = (-S) % c
    padded = [F.pad(x, (0, 0, 0, 0, 0, pad))
              for x in (q, k, v)]
    gates = [F.pad(_t(it), (0, 0, 0, pad)),
             F.pad(_t(ft), (0, 0, 0, pad), value=30.0)]
    h, state = _mlstm_two_pass(*padded, *gates, c)
    want = jops.mlstm_chunkwise(jq, jk, jv, jnp.asarray(it), jnp.asarray(ft),
                                chunk=chunk)
    np.testing.assert_allclose(h[:, :S].float().numpy(), _np(want),
                               **MLSTM_TOL[dtype])
    _, plain_state = mlstm_plain(*padded, *gates, c)
    for got_x, want_x in zip(state, plain_state):
        np.testing.assert_allclose(got_x.numpy(), want_x.numpy(),
                                   rtol=2e-4, atol=2e-4)


def _rglru_segmented(a, x, Lw, T, L):
    """csrc/rglru.cu's segmented scan.  A block owns Lw lanes (a ragged last
    strip is masked) and walks super-chunks of T segments of L steps in
    order; masked steps take a = 1, x = 0.  Pass A: each segment's end
    value Y from 0 and its decay product A, in time order.  Carry: segment
    k starts from c_k = A_{k-1} c_{k-1} + Y_{k-1}, c_0 the block's carry.
    Pass C: the recurrence rerun from c_k; the last segment's last y is the
    next super-chunk's carry.  Products and sums are rounded apart, as
    __fmul_rn and __fadd_rn do.  Mirrors ``rglru_scan_kernel`` in
    csrc/rglru.cu; the last test case below runs the kernel's own layout,
    read from the source."""
    B, S, W = a.shape
    nW = -(-W // Lw) * Lw
    n = -(-S // (T * L)) * T * L
    av = torch.ones(B, n, nW)
    xv = torch.zeros(B, n, nW)
    av[:, :S, :W], xv[:, :S, :W] = a, x
    av, xv = (v.reshape(B, n // (T * L), T, L, nW) for v in (av, xv))
    y = torch.empty_like(av)
    carry = torch.zeros(B, nW)
    for sc in range(n // (T * L)):
        A, Y = torch.ones(B, T, nW), torch.zeros(B, T, nW)
        for i in range(L):
            Y = av[:, sc, :, i] * Y + xv[:, sc, :, i]
            A = A * av[:, sc, :, i]
        c = [carry]
        for k in range(1, T):
            c.append(A[:, k - 1] * c[-1] + Y[:, k - 1])
        c = torch.stack(c, dim=1)                              # (B, T, nW)
        for i in range(L):
            c = av[:, sc, :, i] * c + xv[:, sc, :, i]
            y[:, sc, :, i] = c
        carry = c[:, -1]
    return y.reshape(B, n, nW)[:, :S, :W]


def _rglru_inputs(B, S, W, seed, decay, scaled=True):
    """a and x (B, S, W) fp32: a a sigmoid of a normal, near 1 (1 - 1e-3 u)
    or near 0 (1e-3 u).  Near 1, ``scaled`` multiplies x by the model's
    input normalisation beta = sqrt(1 - a²) (``_rglru_gates``), which keeps
    |y| near 1."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(B, S, W))
    a = {"sigmoid": 1 / (1 + np.exp(-rng.standard_normal((B, S, W)))),
         "near_one": 1 - 1e-3 * u,
         "near_zero": 1e-3 * u}[decay].astype(np.float32)
    x = rng.standard_normal((B, S, W))
    if decay == "near_one" and scaled:
        x = x * np.sqrt(1 - a.astype(np.float64) ** 2)
    return a, x.astype(np.float32)


@pytest.mark.parametrize("B,S,W,Lw,T,L,tb,decay", [
    (1, 1, 40, 16, 4, 8, 12, "sigmoid"),       # one step; a ragged strip
    (1, 7, 40, 16, 4, 8, 12, "sigmoid"),       # L - 1
    (1, 8, 40, 16, 4, 8, 12, "sigmoid"),       # L
    (1, 9, 40, 16, 4, 8, 12, "sigmoid"),       # L + 1
    (1, 33, 40, 16, 4, 8, 20, "sigmoid"),      # T·L + 1: a second super-chunk
    (1, 100, 40, 16, 4, 8, 36, "sigmoid"),     # ragged
    (2, 77, 24, 8, 4, 8, 20, "sigmoid"),       # B = 2
    (1, 4096, 16, 8, 8, 16, 100, "near_one"),  # the carry's error grows most
    (1, 300, 16, 8, 4, 8, 20, "near_zero"),
    (1, 600, 40, *rglru.layout(), 100, "sigmoid"),   # the kernel's layout
])
def test_rglru_segmented_matches_pallas_ref_and_plain(B, S, W, Lw, T, L, tb,
                                                      decay):
    # near 1, x is scaled as the model scales it: unscaled, the fp32
    # references themselves miss the exact value by more than the limit
    # (the next test)
    a, x = _rglru_inputs(B, S, W, S + W + L, decay)
    got = _rglru_segmented(_t(a), _t(x), Lw, T, L)
    plain = rglru_plain(_t(a), _t(x))
    assert got.shape == (B, S, W)
    # the first segment is the plain recurrence, bit for bit
    assert torch.equal(got[:, :L], plain[:, :L])
    pallas = jops.rglru_scan(jnp.asarray(a), jnp.asarray(x), t_blk=tb)
    jax_ref = jref.rglru_ref(jnp.asarray(a), jnp.asarray(x))
    for want in (_np(pallas), _np(jax_ref), plain.numpy()):
        np.testing.assert_allclose(got.numpy(), want, **RGLRU_TOL)


def test_rglru_fp32_references_miss_exact_value_on_unscaled_near_one_input():
    """The near-1 case above without the model's scaling of x: |y| grows to
    about 90, and the sequential fp32 recurrence (``rglru_plain``) and the
    JAX oracle (``jref.rglru_ref``) both miss a float64 recurrence on the
    same fp32 inputs by more than RGLRU_TOL.  So on such input the limit
    cannot tell a fault of the segmented scan from fp32 rounding, and the
    segmented test scales x instead."""
    B, S, W, L = 1, 4096, 16, 16
    a, x = _rglru_inputs(B, S, W, S + W + L, "near_one", scaled=False)
    exact = np.zeros((B, S, W))
    y = np.zeros((B, W))
    for t in range(S):
        y = a[:, t].astype(np.float64) * y + x[:, t]
        exact[:, t] = y
    assert np.abs(exact).max() > 50
    plain = rglru_plain(_t(a), _t(x)).numpy()
    jax_ref = np.asarray(jref.rglru_ref(jnp.asarray(a), jnp.asarray(x)),
                         np.float64)
    limit = RGLRU_TOL["atol"] + RGLRU_TOL["rtol"] * np.abs(exact)
    for got in (plain, jax_ref):
        assert (np.abs(got - exact) > limit).any()


@pytest.mark.parametrize("view,ok", [
    (lambda x: x, True),                       # rows of 80 bytes
    (lambda x: x[:, :, 1:], True),             # a row further on
    (lambda x: x[..., 4:], False),             # starts 8 bytes in
    (lambda x: x[..., :36], True),             # shorter rows, same strides
    (lambda x: x.reshape(2, 3, 2, 80)[..., 4:40], False),
])
def test_tensor_core_kernels_take_16_byte_aligned_rows(view, ok):
    """The tensor-core kernels copy rows 16 bytes at a time: the wrappers
    refuse a tensor whose start or row steps are not 16-byte multiples."""
    x = view(torch.zeros(2, 3, 4, 40, dtype=torch.bfloat16))
    if ok:
        cuda.check_aligned("test", x)
    else:
        with pytest.raises(ValueError):
            cuda.check_aligned("test", x)
