"""The port's ``flash_mha`` (on the CPU its plain version, dense
``attention_ref``) against the reference's ``repro.kernels.flash_mha``
(Pallas, interpret mode) and ``attention_ref``, on the cases of
tests/test_kernels.py:78-116, from the same seeded numpy inputs.

Beside it, ``emulate_kernel``: a plain-torch model of the CUDA kernel's
arithmetic (csrc/flash_attention.cu), held against the same references on
the same cases. Each fp32 operand splits into three round-to-nearest bf16
pieces (fp16 into two where it meets another type), the products run the
cross terms of pieces whose orders sum to at most 2 with fp32 sums, keys
come in 64-key tiles skipped by the reference's liveness rule, the online
softmax keeps -1e30 for masked scores and -inf for keys past T, and p goes
into p.v in three bf16 pieces for an fp32 output and two for a 16-bit
one. The card's sums round in other places, so this shows the precision
plan, not the card's bits.

Tolerances are the reference's own: 2e-5 (fp32) and 3e-2 (bf16) for the
windowed cases, 3e-5 for the sweep and the cross-shaped case. The CUDA
kernel is held against the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_mha as ref_flash_mha  # noqa: E402
from repro.kernels.ref import attention_ref as ref_attention  # noqa: E402
from repro_torch.checkpoint import array_to_torch  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import flash_mha  # noqa: E402
from repro_torch.kernels.ref import NEG_INF, attention_ref  # noqa: E402

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(seed, B, H, S, T, d, dtype=jnp.float32, qk_scale=0.2):
    """q, k, v as jax arrays and bit-identical torch tensors."""
    rng = np.random.default_rng(seed)
    out = []
    for n, sc in ((S, qk_scale), (T, qk_scale), (T, 1.0)):
        x = jnp.asarray((rng.normal(size=(B, H, n, d)) * sc)
                        .astype(np.float32)).astype(dtype)
        out.append((x, array_to_torch(np.asarray(x), "cpu")))
    return out


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def bf16_pieces(x: torch.Tensor, n: int) -> list:
    """x as n bf16 pieces (fp32 tensors of bf16 values), as the kernel
    splits: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
    round to nearest even, each difference exact in fp32."""
    out, r = [], x.float()
    for _ in range(n):
        piece = r.to(torch.bfloat16).float()
        out.append(piece)
        r = r - piece
    return out


def _pieces_of(t: torch.Tensor, f16_product: bool) -> list:
    """The kernel's pieces of an operand: a bf16 one (or an fp16 one in an
    f16 product) as it is, else 2 (fp16) or 3 (fp32) bf16 pieces."""
    if t.dtype == torch.bfloat16 or (t.dtype == torch.float16
                                     and f16_product):
        return [t.float()]
    return bf16_pieces(t.float(), 2 if t.dtype == torch.float16 else 3)


def _cross(a: list, b: list, eq: str) -> torch.Tensor:
    """sum over pieces i of a and j of b with i + j <= 2, smallest terms
    first, of einsum(eq, a_i, b_j), in fp32."""
    acc = None
    for order in (2, 1, 0):
        for i in range(order + 1):
            j = order - i
            if i < len(a) and j < len(b):
                term = torch.einsum(eq, a[i], b[j])
                acc = term if acc is None else acc + term
    return acc


def emulate_kernel(q, k, v, *, causal=True, window=None, scale=None,
                   block_q=128, block_k=128, tile=64):
    """The CUDA kernel's arithmetic in plain torch: q (B,H,S,d), k and v
    (B,H,T,d) of any of fp32, bf16, fp16 -> (B,H,S,d) of q's dtype. The
    rows with no admissible key, [r0, S), are then written apart, as the
    kernel's masked_rows_kernel writes them: the mean of v over the keys of
    the tiles live at the caller's (bq, bk) for the row's query block."""
    B, H, S, d = q.shape
    T = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    f16 = q.dtype == k.dtype == torch.float16
    qp, kp = _pieces_of(q, f16), _pieces_of(k, f16)
    vp = _pieces_of(v, False)
    n_p = 3 if q.dtype == torch.float32 else 2
    out = torch.empty((B, H, S, d))
    for q0 in range(0, S, tile):
        rows = torch.arange(q0, min(q0 + tile, S))
        m = torch.full((B, H, len(rows), 1), NEG_INF)
        l = torch.zeros((B, H, len(rows), 1))
        acc = torch.zeros((B, H, len(rows), d))
        for k0 in range(0, T, tile):
            if causal and k0 > q0 + tile - 1:
                continue
            if window is not None and k0 + tile - 1 < q0 - window + 1:
                continue
            keys = torch.arange(k0, k0 + tile)
            inside = keys < T
            kk = keys.clamp(max=T - 1)
            s = _cross([x[:, :, rows] for x in qp],
                       [x[:, :, kk] * inside[:, None] for x in kp],
                       "bhsd,bhtd->bhst") * scale
            mask = torch.ones((len(rows), tile), dtype=torch.bool)
            if causal:
                mask &= keys[None, :] <= rows[:, None]
            if window is not None:
                mask &= (rows[:, None] - keys[None, :]) < window
            s = torch.where(mask, s, torch.tensor(NEG_INF))
            s = torch.where(inside, s, torch.tensor(-math.inf))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + _cross(
                bf16_pieces(p, n_p), [x[:, :, kk] * inside[:, None]
                                      for x in vp], "bhst,bhtd->bhsd")
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)
    bq, bk = min(block_q, S), min(block_k, T)
    r0 = S
    if window is not None:
        r0 = 0 if causal and window < 1 else max(0, T + window - 1)
    for q0 in range(r0 // bq * bq, S if r0 < S else 0, bq):
        t_hi = -(-T // bk) - 1
        if causal:
            t_hi = min(t_hi, (q0 + bq - 1) // bk)
        need = q0 - window + 1 - (bk - 1)
        t_lo = -(-need // bk) if need > 0 else 0
        acc, n = torch.zeros((B, H, d)), 0
        for t in range(t_lo, t_hi + 1):
            keys = v[:, :, t * bk:min((t + 1) * bk, T)].float()
            acc, n = acc + keys.sum(2), n + keys.shape[2]
        out[:, :, max(q0, r0):q0 + bq] = (acc / max(n, 1e-30))[:, :, None]
    return out.to(q.dtype)


def _check(seed, B, H, S, T, d, *, causal, window=None, bq, bk, dtype, tol):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(seed, B, H, S, T, d, dtype,
                                        qk_scale=0.3 if window else 0.2)
    got = flash_mha(qt, kt, vt, causal=causal, window=window, block_q=bq,
                    block_k=bk)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    emulated = emulate_kernel(qt, kt, vt, causal=causal, window=window,
                              block_q=bq, block_k=bk)
    for want in (ref_flash_mha(qj, kj, vj, causal=causal, window=window,
                               block_q=bq, block_k=bk),
                 ref_attention(qj, kj, vj, causal=causal, window=window)):
        for port in (got, emulated):
            np.testing.assert_allclose(_f32(port), _f32(want), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_basic_matches_reference(window, dtype):
    _check(0, 1, 2, 128, 128, 32, causal=True, window=window, bq=32, bk=32,
           dtype=DTYPES[dtype], tol=2e-5 if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("bq", [32, 64])
@pytest.mark.parametrize("S", [32, 128])
def test_flash_sweep_matches_reference(S, bq, d, causal):
    _check(S + d, 1, 1, S, S, d, causal=causal, bq=bq, bk=bq,
           dtype=jnp.float32, tol=3e-5)


def test_flash_cross_shaped_kv_matches_reference():
    """T != S (scoring a prompt against a longer memory)."""
    _check(1, 1, 2, 64, 128, 32, causal=False, bq=32, bk=32,
           dtype=jnp.float32, tol=3e-5)


def test_flash_scale_reaches_both_paths():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 1, 1, 64, 64, 16)
    from repro.kernels.flash_attention import flash_attention as ref_fa
    from repro_torch.kernels.flash_attention import flash_attention
    got = flash_attention(qt, kt, vt, scale=0.5, block_q=32, block_k=32)
    want = ref_fa(qj, kj, vj, scale=0.5, block_q=32, block_k=32,
                  interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-5, atol=3e-5)


def test_flash_shape_errors_raise():
    q = torch.zeros((1, 1, 64, 16))
    with pytest.raises(ValueError):
        flash_mha(q, q, q, block_q=48)            # 48 does not divide 64
    with pytest.raises(ValueError):
        flash_mha(q, q, q, block_k=24)
    with pytest.raises(ValueError):
        flash_mha(q, torch.zeros((1, 1, 64, 8)), q)
    with pytest.raises(ValueError):
        flash_mha(q, q, torch.zeros((1, 2, 64, 16)))
    with pytest.raises(ValueError):
        flash_mha(q[0], q[0], q[0])


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    (_, qt), (_, kt), (_, vt) = _qkv(3, 1, 2, 64, 64, 16)
    before = flash_mod.launches.count
    got = flash_mha(qt, kt, vt, window=8, block_q=32, block_k=32)
    assert flash_mod.launches.count == before
    assert torch.equal(got, attention_ref(qt, kt, vt, window=8))


MASKED_BLOCKS = [(128, 128), (32, 32), (64, 128), (128, 32)]


@pytest.mark.parametrize("blocks", MASKED_BLOCKS,
                         ids=[f"{a}x{b}" for a, b in MASKED_BLOCKS])
@pytest.mark.parametrize("causal", [True, False])
def test_rows_without_keys_follow_the_reference_blocks(causal, blocks):
    """S 256, T 128, d 32, window 8: rows 135-255 have no admissible key,
    so the reference's blocked kernel gives them the mean of v over the
    keys of the tiles live for their (bq, bk) query block (0 where none is:
    rows 224-255 at blocks 32). The port's flash_mha (its plain version on
    the CPU) and emulate_kernel match the reference's flash_mha (Pallas,
    interpret mode) on every row within fp32's 2e-5, and the reference's
    dense attention_ref on the rows where the two reference versions
    agree: every row that has a key, and at blocks 128 all rows."""
    bq, bk = blocks
    (qj, qt), (kj, kt), (vj, vt) = _qkv(11, 1, 2, 256, 128, 32, qk_scale=0.3)
    kw = dict(causal=causal, window=8)
    want = _f32(ref_flash_mha(qj, kj, vj, block_q=bq, block_k=bk, **kw))
    dense = _f32(ref_attention(qj, kj, vj, **kw))
    got = flash_mha(qt, kt, vt, block_q=bq, block_k=bk, **kw)
    emulated = emulate_kernel(qt, kt, vt, block_q=bq, block_k=bk, **kw)
    agree = np.isclose(want, dense, rtol=2e-5, atol=2e-5).all(-1)
    assert agree[:, :, :135].all()
    assert agree.all() == (blocks == (128, 128))
    for port in (_f32(got), _f32(emulated)):
        np.testing.assert_allclose(port, want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(port[agree], dense[agree], rtol=2e-5,
                                   atol=2e-5)
    # rows with a key stay the dense plain version's, bit for bit
    assert torch.equal(got[:, :, :135], attention_ref(qt, kt, vt, **kw)[:, :, :135])


def test_plain_version_rows_without_keys_take_the_block_rule():
    """flash_attention_plain on hand-made v (v_j = j): a row without keys
    gets the mean over its live tiles' keys, and 0 where no tile is live.
    S 8, T 4, causal, window 1, blocks 2: row i < 4 sees key i alone; rows
    4-7 have none, and the window rule (k0 + 1 >= q0) leaves their query
    blocks no live tile, so they are 0."""
    q = torch.zeros((1, 1, 8, 1))
    v = torch.arange(4.0).reshape(1, 1, 4, 1)
    out = flash_mod.flash_attention_plain(q, q[:, :, :4], v, window=1,
                                          block_q=2, block_k=2)
    assert torch.equal(out[0, 0, :4, 0], v[0, 0, :, 0])   # key i only
    assert torch.equal(out[0, 0, 4:, 0], torch.zeros(4))
    # window 3, blocks 4: rows 6-7 have no key; query block 4-7 keeps tile
    # 0-3 live (3 >= 4 - 3 + 1), so they get the mean of v: 1.5
    out = flash_mod.flash_attention_plain(q, q[:, :, :4], v, window=3,
                                          block_q=4, block_k=4)
    assert torch.equal(out[0, 0, 6:, 0], torch.full((2,), 1.5))


def test_bf16_pieces_sum_to_fp32_exactly():
    """hi + mid + lo == x bit for bit for fp32 normals across the exponent
    range, at the extremes the kernel meets (+-1e-30, +-3e38) and at bf16
    rounding midpoints (ties to even, both ways); each piece a bf16
    value."""
    rng = np.random.default_rng(0)
    mant = rng.uniform(1.0, 2.0, 1 << 16)
    expo = rng.integers(-100, 127, 1 << 16).astype(np.float64)
    sign = rng.choice([-1.0, 1.0], 1 << 16)
    ties = np.array([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, 1 + 2.0 ** -8
                     + 2.0 ** -23, 1.5 + 2.0 ** -8])
    x = np.concatenate([sign * mant * 2.0 ** expo, [1e-30, -1e-30, 3e38,
                                                     -3e38], ties, -ties,
                        rng.normal(size=4096)]).astype(np.float32)
    xt = torch.from_numpy(x)
    pieces = bf16_pieces(xt, 3)
    for p in pieces:
        assert torch.equal(p.to(torch.bfloat16).float(), p)
    total = sum(p.double() for p in pieces)
    assert torch.equal(total, xt.double())
    # two pieces leave at most 2^-16 of |x| (the 16-bit output's plan)
    hi, mid = bf16_pieces(xt, 2)
    assert ((hi.double() + mid.double() - xt.double()).abs()
            <= xt.double().abs() * 2.0 ** -16).all()


@pytest.mark.parametrize("window", [None, 24])
def test_emulation_takes_the_paths_dtype_mix(window):
    """fp32 q and k (as RoPE leaves them) beside bf16 v, the chip path's
    mix, against the reference's kernel and dense attention at fp32's
    2e-5, and the port's flash_mha."""
    rng = np.random.default_rng(5)
    arrs = [(rng.normal(size=(1, 2, 128, 64)) * sc).astype(np.float32)
            for sc in (0.3, 0.3, 1.0)]
    qj, kj = jnp.asarray(arrs[0]), jnp.asarray(arrs[1])
    vj = jnp.asarray(arrs[2]).astype(jnp.bfloat16)
    qt, kt = (torch.from_numpy(a) for a in arrs[:2])
    vt = array_to_torch(np.asarray(vj), "cpu")
    got = emulate_kernel(qt, kt, vt, window=window)
    assert got.dtype == torch.float32
    for want in (ref_flash_mha(qj, kj, vj, window=window, block_q=64,
                               block_k=64),
                 ref_attention(qj, kj, vj, window=window),
                 flash_mha(qt, kt, vt, window=window)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("dtypes", [("float32", "float32", "float32"),
                                    ("bfloat16", "bfloat16", "bfloat16"),
                                    ("float16", "float16", "float16"),
                                    ("bfloat16", "float32", "float16")])
def test_emulation_covers_ragged_tiles_and_masked_first_tiles(dtypes):
    """S = T = 200 (partial last tiles: keys past T are -inf) and window
    16, under which rows 80-127 meet a fully masked first live tile (m
    stays -1e30 until a real key wipes it), against dense attention_ref:
    fp32 at 2e-5, 16-bit outputs within one ulp of the output's type."""
    rng = np.random.default_rng(len("".join(dtypes)))
    q, k, v = (torch.from_numpy((rng.normal(size=(1, 2, 200, 32)) * sc)
                                .astype(np.float32)).to(getattr(torch, dt))
               for sc, dt in zip((0.3, 0.3, 1.0), dtypes))
    for causal, window in ((True, None), (True, 16), (False, 50)):
        got = emulate_kernel(q, k, v, causal=causal, window=window)
        want = attention_ref(q, k, v, causal=causal, window=window)
        err = (got.float() - want.float()).abs()
        if q.dtype == torch.float32:
            lim = 2e-5 + 2e-5 * want.float().abs()
        else:
            lim = 2e-5 + want.float().abs() * torch.finfo(q.dtype).eps
        assert (err <= lim).all(), err.max().item()


def test_build_report_reads_ptxas_registers_and_spills(tmp_path, monkeypatch):
    """``_build.ptxas_report`` (what chip_smoke's [build] proves the kernel
    with) reads registers and spill bytes per kernel from nvcc's -Xptxas -v
    log, and keeps ptxas's warnings."""
    from repro_torch.kernels import _build
    lib = tmp_path / "libflash_attention-0.so"
    lib.with_suffix(".log").write_text(
        "ptxas info    : Compiling entry function '_Z3fooILi64ELb1EEv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooILi64ELb1EEv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 241 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z3fooILi128ELb1EEv' for "
        "'sm_90a'\n"
        "ptxas warning : (C7510) wgmma serialized in '_Z3fooILi128ELb1EEv'\n"
        "ptxas info    : Function properties for _Z3fooILi128ELb1EEv\n"
        "    8 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n")
    monkeypatch.setattr(_build, "lib_path", lambda source: lib)
    rep = _build.ptxas_report("flash_attention.cu")
    assert rep["_Z3fooILi64ELb1EEv"] == {"registers": 241, "spill_bytes": 0,
                                         "warnings": []}
    big = rep["_Z3fooILi128ELb1EEv"]
    assert (big["registers"], big["spill_bytes"]) == (255, 40)
    assert len(big["warnings"]) == 1
