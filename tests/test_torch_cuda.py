"""The port's CUDA kernels against their plain PyTorch versions on the card,
bit for bit, including lengths that exercise the masked scalar edge and
misaligned views that exercise the scalar path: the raw mix (in place, and
out of place through ``gossip_mix_flat`` / ``gossip_mix_tree``), the quantized
mix ``gossip_mix_q`` (also on lengths cut around one block's chunk, views
offset by 1-7 elements and per-row alphas on rows that straddle chunks), the fused SGD and AdamW sweeps with raw, bf16 (on
fp32) and int8 / fp8 wire partners, and the fused LARS sweep with raw
partners of either width and a per-row trust scale, under a static alpha,
a () tensor alpha and one alpha per replica row. The forward-only kernels:
``ssm_scan`` bit for bit against its plain sequential loop (ragged S and D
included); the scan under autograd, ``ssm_scan_train``, its forward and
adjoint kernels bit for bit against their plain loops, and a reduced
falcon-mamba's loss and gradients through the chunked train scan, remat on,
against the CPU's, with the kernels' launches counted; ``flash_attention`` against its plain version (dense
``attention_ref``; rows with no admissible key by the caller's blocks) within
the reference's fp32 tolerance (2e-5) and, in bf16, within one bf16 ulp of the
plain output plus 2e-5 (the final cast splits an fp32 gap below 2e-5);
refused launches raise, and so does a call that autograd would record.
Beside the kernels: the replica mean of ``agd`` and ``every_logp`` equals
the CPU's bit for bit, and a state trained and saved on the card restores
on the CPU bit for bit; a shard-local (fsdp) layout's pack, unpack and
packed gradient, and a fused step over its buckets, equal the CPU's bit for
bit. Serving (no kernel on its path): prefill and decode of reduced fp32
qwen3, qwen3 with a 4-slot window and falcon-mamba on the card against the
CPU (logits and every cache leaf within rtol = atol = 2e-4, greedy tokens
equal), and two ``generate`` calls on the card giving equal tokens. The
smoke script's profile rows, summed from the profiler's raw events, equal
``key_averages()``'s on a small profile.

Marked ``cuda``; they skip on a machine without a card. This file imports
neither JAX nor the reference, so on a machine with a card and no JAX it
runs without the repo's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (fused_adamw_1d,  # noqa: E402
                                 fused_adamw_plain, fused_lars_1d,
                                 fused_lars_plain, fused_sgd_1d,
                                 fused_sgd_plain, fused_update, gossip_mix,
                                 gossip_mix_1d, gossip_mix_plain,
                                 gossip_mix_q2d, gossip_mix_q_plain)
from repro_torch.kernels import (_build, flash_mha, ssm_scan,  # noqa: E402
                                 ssm_scan_train)
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.quantize import encode_wire, wire_key  # noqa: E402
from repro_torch.kernels.ref import (attention_ref,  # noqa: E402
                                     ssm_scan_bwd_ref, ssm_scan_ref)
from repro_torch.kernels.ssm_scan_kernel import launches as ssm_launches  # noqa: E402
from repro_torch.kernels.ssm_scan_kernel import (  # noqa: E402
    bwd_launches as ssm_bwd_launches, train_launches as ssm_train_launches)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _alphas(dev):
    return (0.5, 0.0, torch.tensor(0.25, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(1, 0), (7, 0), (128 * 1000 + 3, 0),
                                      (4096, 1)])
def test_kernels_match_plain_bitwise(cuda_device, dtype, n, offset):
    gen = torch.Generator(device=cuda_device).manual_seed(n)

    def mk():  # offset > 0: a view that is not 16-byte aligned
        t = torch.randn(n + offset, generator=gen, device=cuda_device)
        return t.to(dtype)[offset:]

    p, g, b, m = mk(), mk(), mk(), mk()
    for alpha in _alphas(cuda_device):
        for mom in (m, None):
            before = fused_update.launches.count
            wp, wm = fused_sgd_plain(p, g, b, mom, lr=0.01, alpha=alpha,
                                     weight_decay=1e-4)
            gp = p.clone()
            gm = mom.clone() if mom is not None else None
            fused_sgd_1d(gp, g, b, gm, lr=0.01, alpha=alpha, weight_decay=1e-4)
            torch.cuda.synchronize()
            assert fused_update.launches.count == before + 1
            assert torch.equal(gp, wp)
            if mom is not None:
                assert torch.equal(gm, wm)
        before = gossip_mix.launches.count
        got = gossip_mix_1d(p.clone(), b, alpha)
        torch.cuda.synchronize()
        assert gossip_mix.launches.count == before + 1
        assert torch.equal(got, gossip_mix_plain(p, b, alpha))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [((1,), 0), ((7,), 0),
                                          ((128 * 1000 + 3,), 0),
                                          ((4096,), 1), ((3, 7, 11), 0)])
def test_mix_flat_out_of_place_matches_plain(cuda_device, dtype, shape,
                                             offset):
    """``gossip_mix_flat`` (the kernel writing a fresh buffer through its
    ``out`` pointer): one launch, bit-equal to the plain version, ``a``
    untouched, on ragged lengths and a misaligned view (the scalar path);
    ``gossip_mix_tree`` launches once a leaf."""
    from repro_torch.kernels import gossip_mix_flat, gossip_mix_tree
    n = 1
    for d in shape:
        n *= d
    gen = torch.Generator(device=cuda_device).manual_seed(n)

    def mk():
        t = torch.randn(n + offset, generator=gen, device=cuda_device)
        return t.to(dtype)[offset:].view(shape)

    a, b = mk(), mk()
    a0 = a.clone()
    for alpha in _alphas(cuda_device):
        before = gossip_mix.launches.count
        got = gossip_mix_flat(a, b, alpha)
        torch.cuda.synchronize()
        assert gossip_mix.launches.count == before + 1
        assert got.shape == a.shape and got.data_ptr() != a.data_ptr()
        assert torch.equal(got, gossip_mix_plain(a, b, alpha))
        assert torch.equal(a, a0)
    before = gossip_mix.launches.count
    tree = gossip_mix_tree({"x": a, "y": [b]}, {"x": b, "y": [a]}, 0.5)
    torch.cuda.synchronize()
    assert gossip_mix.launches.count == before + 2
    assert torch.equal(tree["y"][0], gossip_mix_plain(b, a, 0.5))


@pytest.mark.cuda
def test_kernel_rejects_mismatched_buffers(cuda_device):
    p = torch.zeros(256, device=cuda_device)
    with pytest.raises(ValueError):
        fused_sgd_1d(p, torch.zeros(256, device=cuda_device,
                                    dtype=torch.bfloat16), None, None, lr=0.1)
    with pytest.raises(ValueError, match="aliases"):
        fused_sgd_1d(p, p.clone(), p, None, lr=0.1)


def _wire_alphas(dev, rows):
    return (0.5, 0.0, torch.tensor(0.25, device=dev),
            torch.tensor([0.5, 0.0, 0.25, 0.125][:rows], device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("code", ["int8", "fp8"])
@pytest.mark.parametrize("rows,n", [(4, 128 * 37), (2, 128 * 3)])
def test_wire_kernels_match_plain_bitwise(cuda_device, dtype, code, rows, n):
    """q-mix and the scaled fused sweep, every alpha form. (2, 384) bf16
    rows are 768 bytes, (4, 4736) fp32 rows 18,944: both 16-byte multiples;
    the unaligned views of the next test take the scalar path."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + rows)
    mk = lambda: torch.randn(rows, n, generator=gen,  # noqa: E731
                             device=cuda_device).to(dtype)
    p, g, m = mk(), mk(), mk()
    enc = encode_wire(mk(), code, keys=wire_key(3, range(rows), 1))
    q, s = enc["q"], enc["s"]
    for alpha in _wire_alphas(cuda_device, rows):
        before = gossip_mix.q_launches.count
        got = gossip_mix_q2d(p.clone(), q, s, alpha)
        torch.cuda.synchronize()
        assert gossip_mix.q_launches.count == before + 1
        assert torch.equal(got, gossip_mix_q_plain(p, q, s, alpha))
        for mom in (m, None):
            before = fused_update.scaled_launches.count
            wp, wm = fused_sgd_plain(p, g, q, mom, lr=0.01, alpha=alpha,
                                     weight_decay=1e-4, partner_scales=s)
            gp = p.clone()
            gm = mom.clone() if mom is not None else None
            fused_sgd_1d(gp, g, q, gm, lr=0.01, alpha=alpha,
                         weight_decay=1e-4, partner_scales=s)
            torch.cuda.synchronize()
            dropped = not isinstance(alpha, torch.Tensor) and alpha == 0.0
            assert fused_update.scaled_launches.count == before + (not dropped)
            assert torch.equal(gp, wp)
            if mom is not None:
                assert torch.equal(gm, wm)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(128 * 8, 0), (128 * 8, 1),
                                      (128 * 9 + 5, 0)])
def test_mixed_dtype_partner_and_row_alpha_match_plain(cuda_device, n, offset):
    """A bf16 partner on an fp32 bucket, per-row and () tensor alphas;
    offset 1 makes views that are not 16-byte aligned (scalar path)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + offset)

    def mk(dtype):
        t = torch.randn(2 * n + offset, generator=gen, device=cuda_device)
        return t.to(dtype)[offset:].view(2, n)

    p, g, m = mk(torch.float32), mk(torch.float32), mk(torch.float32)
    b = mk(torch.bfloat16)
    for alpha in _wire_alphas(cuda_device, 2):
        got = gossip_mix_1d(p.clone(), b, alpha)
        torch.cuda.synchronize()
        assert torch.equal(got, gossip_mix_plain(p, b, alpha))
        wp, wm = fused_sgd_plain(p, g, b, m, lr=0.01, alpha=alpha)
        gp, gm = p.clone(), m.clone()
        fused_sgd_1d(gp, g, b, gm, lr=0.01, alpha=alpha)
        torch.cuda.synchronize()
        assert torch.equal(gp, wp) and torch.equal(gm, wm)


def _coded_view(q: torch.Tensor, offset: int) -> torch.Tensor:
    """q's codes copied into a view that starts ``offset`` elements into a
    fresh buffer (not aligned for a vector when offset > 0)."""
    buf = torch.empty(q.numel() + offset, dtype=q.dtype, device=q.device)
    view = buf[offset:].view(q.shape)
    view.copy_(q)
    return view


# bytes of a that one block of the mix kernel owns: 1024 16-byte vectors
# (csrc/gossip_mix.cu: kChunk)
MIX_CHUNK_BYTES = 16 * 1024
SWEEP_CASES = [(torch.float32, "raw"), (torch.float32, "bf16"),
               (torch.float32, "int8"), (torch.float32, "fp8"),
               (torch.bfloat16, "raw"), (torch.bfloat16, "int8"),
               (torch.bfloat16, "fp8")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,partner", SWEEP_CASES,
                         ids=[f"{str(d)[6:]}-{p}" for d, p in SWEEP_CASES])
def test_mix_sweep_ragged_and_misaligned_match_plain(cuda_device, dtype,
                                                     partner):
    """The mix sweep (one chunk of MIX_CHUNK_BYTES of a per block, its loads
    batched) against its plain version bit for bit, every alpha form, on
    lengths that are no multiple of a chunk: below one vector, one element
    (codes: one 128-row) past a chunk, a prime; and on views offset by 1-7
    elements (the scalar loop). Raw partners of the bucket's dtype or bf16
    on fp32 take any length; wire codes take (M, 128 k)."""
    chunk = MIX_CHUNK_BYTES // dtype.itemsize   # elements a block owns
    gen = torch.Generator(device=cuda_device).manual_seed(chunk + len(partner))
    coded = partner in ("int8", "fp8")
    if coded:
        shapes = [(1, 128), (1, chunk + 128), (3, 128 * 67), (2, chunk)]
    else:
        shapes = [(1, 1), (1, 3), (1, 7), (1, chunk + 1), (1, 2 * chunk - 1),
                  (1, 100_003), (2, 128 * 67)]
    cases = [(sh, 0) for sh in shapes] + [((2, 128 * 5), off)
                                          for off in range(1, 8)]
    for (rows, n), offset in cases:
        a = torch.randn(rows * n + offset, generator=gen,
                        device=cuda_device).to(dtype)[offset:].view(rows, n)
        b = torch.randn(rows, n, generator=gen, device=cuda_device)
        if coded:
            enc = encode_wire(b.to(dtype), partner,
                              keys=wire_key(1, range(rows), 2))
            q, s = _coded_view(enc["q"], offset), enc["s"]
        else:
            b = b.to(dtype if partner == "raw" else torch.bfloat16)
            b = _coded_view(b, offset)
        for alpha in _wire_alphas(cuda_device, rows):
            if coded:
                got = gossip_mix_q2d(a.clone(), q, s, alpha)
                want = gossip_mix_q_plain(a, q, s, alpha)
            else:
                got = gossip_mix_1d(a.clone(), b, alpha)
                want = gossip_mix_plain(a, b, alpha)
            torch.cuda.synchronize()
            assert torch.equal(got, want), ((rows, n), offset, alpha)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("coded", [False, True], ids=["raw", "int8"])
@pytest.mark.parametrize("k", [3, 67, 129])
def test_mix_sweep_row_alpha_straddles_chunks(cuda_device, dtype, coded, k):
    """One alpha per replica row, rows of 128 k elements: k 3 puts many rows
    in one block's chunk, k 67 and 129 make chunks that straddle two rows
    (fp32 chunks hold 4096 elements, bf16 8192)."""
    rows, n = 5, 128 * k
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    a = torch.randn(rows, n, generator=gen, device=cuda_device).to(dtype)
    b = torch.randn(rows, n, generator=gen, device=cuda_device).to(dtype)
    alpha = torch.tensor([0.5, 0.0, 0.25, 0.125, 1.0], device=cuda_device)
    if coded:
        enc = encode_wire(b, "int8", keys=wire_key(2, range(rows), 3))
        got = gossip_mix_q2d(a.clone(), enc["q"], enc["s"], alpha)
        want = gossip_mix_q_plain(a, enc["q"], enc["s"], alpha)
    else:
        got = gossip_mix_1d(a.clone(), b, alpha)
        want = gossip_mix_plain(a, b, alpha)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_wire_kernels_reject_bad_streams(cuda_device):
    p = torch.zeros(2, 256, device=cuda_device)
    q = torch.zeros(2, 256, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="alpha"):
        gossip_mix_q2d(p, q, torch.ones(2, 2, device=cuda_device),
                       torch.tensor(0.5))  # alpha left on the host
    with pytest.raises(ValueError, match="partner_scales"):
        fused_sgd_1d(p, p.clone(), q, None, lr=0.1,
                     partner_scales=torch.ones(3, device=cuda_device))
    with pytest.raises(TypeError):  # codes without scales
        fused_sgd_1d(p, p.clone(), q, None, lr=0.1)


# ---------------------------------------------------------- adamw and lars

def _adamw_args(t):
    from repro_torch.optim.optimizers import bias_correction
    return dict(lr=0.01, c1=bias_correction(0.9, t), c2=bias_correction(0.95, t),
                weight_decay=0.02)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(1, 0), (7, 0), (128 * 1000 + 3, 0),
                                      (4096, 1)])
def test_adamw_kernel_matches_plain_bitwise(cuda_device, dtype, n, offset):
    """Raw partners (the bucket's dtype, and bf16 on fp32) and no partner,
    every alpha form, ragged lengths and unaligned views (scalar path)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + 7)

    def mk(dt, scale=1.0):
        t = torch.randn(2 * n + offset, generator=gen, device=cuda_device)
        return (t * scale).to(dt)[offset:].view(2, n)

    p, g, b = mk(dtype), mk(dtype, 0.1), mk(dtype)
    m, v = mk(torch.float32, 0.01), mk(torch.float32, 1e-3).abs()
    partners = [b, None] + ([b.to(torch.bfloat16)]
                            if dtype == torch.float32 else [])
    for step in (1, 7):
        for partner in partners:
            for alpha in _wire_alphas(cuda_device, 2):
                before = fused_update.adamw_launches.count
                want = fused_adamw_plain(p, g, partner, m, v, alpha=alpha,
                                         **_adamw_args(step))
                got = (p.clone(), m.clone(), v.clone())
                fused_adamw_1d(got[0], g, partner, got[1], got[2],
                               alpha=alpha, **_adamw_args(step))
                torch.cuda.synchronize()
                assert fused_update.adamw_launches.count == before + 1
                for x, y in zip(got, want):
                    assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("code", ["int8", "fp8"])
def test_adamw_wire_kernel_matches_plain_bitwise(cuda_device, dtype, code):
    rows, n = 4, 128 * 37
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    mk = lambda s: (torch.randn(rows, n, generator=gen,  # noqa: E731
                                device=cuda_device) * s)
    p, g = mk(1.0).to(dtype), mk(0.1).to(dtype)
    m, v = mk(0.01), mk(1e-3).abs()
    enc = encode_wire(mk(1.0).to(dtype), code, keys=wire_key(3, range(rows), 1))
    for alpha in _wire_alphas(cuda_device, rows):
        before = fused_update.adamw_scaled_launches.count
        want = fused_adamw_plain(p, g, enc["q"], m, v, alpha=alpha,
                                 partner_scales=enc["s"], **_adamw_args(3))
        got = (p.clone(), m.clone(), v.clone())
        fused_adamw_1d(got[0], g, enc["q"], got[1], got[2], alpha=alpha,
                       partner_scales=enc["s"], **_adamw_args(3))
        torch.cuda.synchronize()
        dropped = not isinstance(alpha, torch.Tensor) and alpha == 0.0
        assert fused_update.adamw_scaled_launches.count == before + (not dropped)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n,offset", [(4, 128 * 37, 0), (2, 128 * 3, 0),
                                           (2, 128 * 5, 1)])
def test_lars_kernel_matches_plain_bitwise(cuda_device, dtype, rows, n,
                                           offset):
    """Partners of the bucket's dtype, the other width (fp32 on bf16 and
    bf16 on fp32) and none, a row scale per 128 elements, every alpha form;
    offset 1 makes views that are not 16-byte aligned (scalar path)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + rows + offset)

    def mk(dt, scale=1.0):
        t = torch.randn(rows * n + offset, generator=gen, device=cuda_device)
        return (t * scale).to(dt)[offset:].view(rows, n)

    p, g, b = mk(dtype), mk(dtype, 0.1), mk(dtype)
    m = mk(torch.float32, 0.01)
    scale = torch.rand(rows * n // 128, generator=gen,
                       device=cuda_device) * 1e-2
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    for partner in (b, b.to(other), None):
        for alpha in _wire_alphas(cuda_device, rows):
            before = fused_update.lars_launches.count
            want = fused_lars_plain(p, g, partner, m, scale, lr=0.1,
                                    alpha=alpha, weight_decay=1e-4)
            gp, gm = p.clone(), m.clone()
            fused_lars_1d(gp, g, partner, gm, scale, lr=0.1, alpha=alpha,
                          weight_decay=1e-4)
            torch.cuda.synchronize()
            assert fused_update.lars_launches.count == before + 1
            assert torch.equal(gp, want[0]) and torch.equal(gm, want[1])


@pytest.mark.cuda
def test_adamw_lars_kernels_reject_bad_streams(cuda_device):
    p = torch.zeros(2, 256, device=cuda_device, dtype=torch.bfloat16)
    m = torch.zeros(2, 256, device=cuda_device)
    with pytest.raises(ValueError, match="m:"):  # moments must be fp32
        fused_adamw_1d(p, p.clone(), None, p.clone(), m.clone(),
                       **_adamw_args(1))
    with pytest.raises(ValueError, match="row_scale"):
        fused_lars_1d(p, p.clone(), None, m, torch.ones(3, device=cuda_device),
                      lr=0.1)
    with pytest.raises(ValueError, match="row_scale"):  # scales on the host
        fused_lars_1d(p, p.clone(), None, m, torch.ones(4), lr=0.1)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (x fp32): 2^(e - 8) for |x| = m 2^e,
    m in [0.5, 1); 0 at 0."""
    _, e = torch.frexp(x.abs())
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def assert_attention_close(got: torch.Tensor, want: torch.Tensor) -> float:
    """fp32: rtol = atol = 2e-5 (tests/test_kernels.py:86); bf16: one bf16
    ulp of the plain output, plus 2e-5 where that ulp is smaller."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype == torch.float32:
        assert (err <= 2e-5 + 2e-5 * w.abs()).all(), err.max().item()
    else:
        assert (err <= bf16_ulp(w) + 2e-5).all(), err.max().item()
    return err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 32, 16), (3, 100, 10, 5),
                                   (1, 1, 7, 3), (2, 9, 3, 1)])
def test_ssm_scan_kernel_matches_plain_bitwise(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    dA = torch.rand(shape, generator=gen, device=cuda_device) * 0.8 + 0.2
    dBx = torch.randn(shape, generator=gen, device=cuda_device)
    before = ssm_launches.count
    got = ssm_scan(dA, dBx)
    torch.cuda.synchronize()
    assert ssm_launches.count == before + 1
    assert torch.equal(got, ssm_scan_ref(dA, dBx))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 7, 3), (1, 7, 5, 3), (3, 33, 10, 5),
                                   (1, 4096, 33, 3), (2, 9, 3, 1)])
def test_ssm_scan_train_kernels_match_plain_bitwise(cuda_device, shape):
    """``ssm_scan_train`` on the card: one ``ssm_scan.cu`` launch forward
    and one ``ssm_scan_bwd.cu`` launch backward, h bit-equal to
    ``ssm_scan_ref`` and (ddA, ddBx) to ``ssm_scan_bwd_ref``; S = 1, below
    and past the unroll of 8, and odd D * N."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape) + 1)
    dA = torch.rand(shape, generator=gen, device=cuda_device) * 0.8 + 0.2
    dBx = torch.randn(shape, generator=gen, device=cuda_device)
    dh = torch.randn(shape, generator=gen, device=cuda_device)
    before = (ssm_launches.count, ssm_train_launches.count,
              ssm_bwd_launches.count)
    a, b = dA.clone().requires_grad_(True), dBx.clone().requires_grad_(True)
    h = ssm_scan_train(a, b)
    h.backward(dh)
    torch.cuda.synchronize()
    assert (ssm_launches.count, ssm_train_launches.count,
            ssm_bwd_launches.count) == (before[0], before[1] + 1,
                                        before[2] + 1)
    assert torch.equal(h.detach(), ssm_scan_ref(dA, dBx))
    want_a, want_b = ssm_scan_bwd_ref(dA, h.detach(), dh)
    assert torch.equal(a.grad, want_a) and torch.equal(b.grad, want_b)


@pytest.mark.cuda
def test_mamba_train_step_through_the_scan_kernels_matches_cpu(cuda_device):
    """The loss and every gradient of a reduced fp32 falcon-mamba under
    remat through ``partial(ssm_scan_chunked_torch, chunk=256)`` on 2 x 512
    tokens: on the card 2 forward launches a layer (the forward and remat's
    recompute) and 1 backward launch; against the same on the CPU (the
    reference's chunk loop) within tests/test_torch_remat.py's tolerances
    (loss rtol 1e-4, gradients 1e-4 of their largest magnitude)."""
    import dataclasses
    import functools

    from repro_torch.configs import get_config
    from repro_torch.models import lm_init, reduced
    from repro_torch.models.mamba import ssm_scan_chunked_torch
    from repro_torch.train import make_loss_fn
    from repro_torch.tree import tree_flatten, tree_map
    cfg = dataclasses.replace(reduced(get_config("falcon-mamba-7b")),
                              param_dtype="float32", compute_dtype="float32")
    loss_fn = make_loss_fn(cfg, remat=True, ssm_scan_impl=functools.partial(
        ssm_scan_chunked_torch, chunk=256))
    cpu = lm_init(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 2, 513),
                         generator=torch.Generator().manual_seed(4))
    runs = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda w: w[None].to(dev).requires_grad_(True), cpu)
        before = (ssm_train_launches.count, ssm_bwd_launches.count)
        loss, _ = loss_fn(p, {"tokens": toks.to(dev)})
        loss.sum().backward()
        leaves = tree_flatten(p)[0]
        runs[str(dev)] = [loss.detach().cpu()] + [w.grad.cpu() for w in leaves]
        launched = (ssm_train_launches.count - before[0],
                    ssm_bwd_launches.count - before[1])
        assert launched == ((0, 0) if dev == "cpu"
                            else (2 * cfg.n_layers, cfg.n_layers)), launched
    want, got = runs["cpu"], runs[str(cuda_device)]
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * max(w.abs().max().item(),
                                                   1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,T,d,causal,window", [
    (1, 2, 128, 128, 32, True, None), (1, 2, 128, 128, 32, True, 32),
    (1, 1, 96, 96, 16, False, None), (1, 2, 64, 128, 64, False, None),
    (2, 2, 256, 256, 128, True, None), (1, 1, 128, 128, 256, True, 64),
    (1, 1, 64, 64, 80, True, None)])
def test_flash_kernel_matches_plain(cuda_device, dtype, B, H, S, T, d, causal,
                                    window):
    gen = torch.Generator(device=cuda_device).manual_seed(S + T + d)

    def mk(n, sc):
        return (torch.randn((B, H, n, d), generator=gen, device=cuda_device)
                * sc).to(dtype)

    q, k, v = mk(S, 0.3), mk(T, 0.3), mk(T, 1.0)
    before = flash_mod.launches.count
    got = flash_mha(q, k, v, causal=causal, window=window, block_q=32,
                    block_k=32)
    torch.cuda.synchronize()
    assert flash_mod.launches.count == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert_attention_close(got, attention_ref(q, k, v, causal=causal,
                                              window=window))


@pytest.mark.cuda
def test_flash_kernel_takes_mixed_dtypes(cuda_device):
    """fp32 q and k (as RoPE leaves them) with bf16 v: the kernel reads
    each in its own dtype and casts it to fp32 as the reference's kernel
    does, in one launch; the output has q's dtype."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, k = (torch.randn((1, 2, 128, 64), generator=gen, device=cuda_device)
            * 0.3 for _ in range(2))
    v = torch.randn((1, 2, 128, 64), generator=gen,
                    device=cuda_device).bfloat16()
    before = flash_mod.launches.count
    got = flash_mha(q, k, v)
    assert got.dtype == torch.float32
    assert_attention_close(got, attention_ref(q, k, v))
    got = flash_mha(v, k, v.half())
    assert got.dtype == torch.bfloat16
    assert_attention_close(got, attention_ref(v, k, v.half()))
    assert flash_mod.launches.count == before + 2


def _flash_case(dev, dtypes, B, H, S, T, d, causal, window, block):
    """One flash_mha launch on q, k, v of the given dtypes against dense
    attention_ref on the same tensors."""
    gen = torch.Generator(device=dev).manual_seed(S + T + d + B * H)
    q, k, v = ((torch.randn((B, H, n, d), generator=gen, device=dev) * sc)
               .to(dt) for n, sc, dt in zip((S, T, T), (0.3, 0.3, 1.0),
                                            dtypes))
    before = flash_mod.launches.count
    got = flash_mha(q, k, v, causal=causal, window=window, block_q=block,
                    block_k=block)
    torch.cuda.synchronize()
    assert flash_mod.launches.count == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    assert_attention_close(got, attention_ref(q, k, v, causal=causal,
                                              window=window))


F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("dtypes", [(F32, F32, BF16), (BF16, BF16, BF16),
                                    (F32, F32, F32), (F16, F16, F16)])
def test_flash_kernel_split_passes_per_dtype_mix(cuda_device, dtypes, window):
    """The split-bf16 pass plans at d 128: fp32 q and k in 3 pieces each
    beside bf16 v (the path's mix), one bf16 pass, fp32 everywhere, and
    the f16 product of fp16 q and k."""
    _flash_case(cuda_device, dtypes, 1, 2, 256, 256, 128, True, window, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", [24, 72])
def test_flash_kernel_pads_head_dim_in_shared_memory(cuda_device, d, dtype):
    """d that is not a multiple of 16: zero columns in shared memory."""
    _flash_case(cuda_device, (dtype,) * 3, 1, 2, 128, 128, d, True, None, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes,d", [((F32, F32, BF16), 256),
                                      ((BF16,) * 3, 20), ((F32,) * 3, 20),
                                      ((F16, F32, F16), 128)])
def test_flash_kernel_load_modes(cuda_device, dtypes, d):
    """The loads beside the staged one: d 256 with fp32 q and k (direct,
    K split through registers), d % 8 != 0 (direct, scalar loads), and
    fp16 pieces beside fp32 ones (staged, fp16 tiles split in shared
    memory)."""
    _flash_case(cuda_device, dtypes, 1, 2, 192, 192, d, True, 80, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, 50)])
def test_flash_kernel_ragged_query_tile(cuda_device, dtype, causal, window):
    """S = T = 200: the last query and key tiles are partial."""
    _flash_case(cuda_device, (dtype,) * 3, 1, 2, 200, 200, 64, causal,
                window, 40)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(F32, F32, BF16), (BF16, BF16, BF16)])
def test_flash_kernel_fully_masked_first_live_tile(cuda_device, dtypes):
    """Window 16: for rows 80-127 the first live key tile (keys 0-63) is
    fully masked, so m stays -1e30 until a real key wipes the tile."""
    _flash_case(cuda_device, dtypes, 1, 2, 256, 256, 64, True, 16, 64)


MASKED_BLOCKS = [(128, 128), (32, 32), (64, 128), (128, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("blocks", MASKED_BLOCKS,
                         ids=[f"{a}x{b}" for a, b in MASKED_BLOCKS])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_rows_without_keys_take_the_callers_blocks(
        cuda_device, causal, blocks, dtype):
    """S 256, T 128, d 32, window 8: rows 135-255 have no admissible key and
    take the mean of v over the keys of the tiles live at the caller's
    (block_q, block_k) for their query block (0 where none is), as the
    reference's blocked kernel gives them; the kernel against its plain
    version ``flash_attention_plain`` on every row."""
    bq, bk = blocks
    gen = torch.Generator(device=cuda_device).manual_seed(bq + bk + causal)
    q, k, v = ((torch.randn((1, 2, n, 32), generator=gen, device=cuda_device)
                * sc).to(dtype) for n, sc in ((256, 0.3), (128, 0.3),
                                              (128, 1.0)))
    kw = dict(causal=causal, window=8, block_q=bq, block_k=bk)
    before = flash_mod.launches.count
    got = flash_mha(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_mod.launches.count == before + 1
    want = flash_mod.flash_attention_plain(q, k, v, **kw)
    assert_attention_close(got, want)
    if bq == 32:   # rows 224-255: no tile is live at (32, 32) or (32, x)
        assert not want[:, :, 224:].any() and not got[:, :, 224:].any()


@pytest.mark.cuda
def test_forward_only_kernels_refuse_bad_calls(cuda_device):
    q = torch.randn((1, 1, 64, 16), device=cuda_device)
    with pytest.raises(ValueError):
        flash_mha(q, q, q, block_q=48)          # 48 does not divide 64
    with pytest.raises(ValueError):
        flash_mha(torch.zeros((1, 1, 64, 300), device=cuda_device),
                  torch.zeros((1, 1, 64, 300), device=cuda_device),
                  torch.zeros((1, 1, 64, 300), device=cuda_device))
    with pytest.raises(TypeError):
        flash_mha(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        ssm_scan(q.double(), q.double())
    # launches the C entry points refuse: an unknown dtype code, a grid
    # past 2^31 blocks; the wrappers' check raises on their error codes
    s = torch.cuda.current_stream(cuda_device).cuda_stream
    for codes, blocks in (((7, 0, 0), (64, 64)), ((0, 0, 2), (64, 64)),
                          ((0, 0, 0), (0, 64))):
        rc = _build.kernel("flash_attention")(*codes, None, None, None, None,
                                              1, 64, 64, 16, 1.0, 1, 0, 0,
                                              *blocks, s)
        with pytest.raises(RuntimeError, match="failed to launch"):
            _build.check_launch("flash_attention", rc)
    rc = _build.kernel("ssm_scan")(None, None, None, 1 << 20, 4, 1 << 22, s)
    with pytest.raises(RuntimeError, match="failed to launch"):
        _build.check_launch("ssm_scan", rc)


@pytest.mark.cuda
def test_forward_only_kernels_refuse_grad(cuda_device):
    q = torch.randn((1, 1, 64, 16), device=cuda_device, requires_grad=True)
    dA = torch.rand((1, 8, 4, 2), device=cuda_device, requires_grad=True)
    before = (flash_mod.launches.count, ssm_launches.count)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_mha(q, q, q)
    with pytest.raises(RuntimeError, match="forward-only"):
        ssm_scan(dA, dA)
    assert (flash_mod.launches.count, ssm_launches.count) == before
    with torch.no_grad():
        flash_mha(q, q, q)
        ssm_scan(dA, dA)
    torch.cuda.synchronize()
    assert (flash_mod.launches.count, ssm_launches.count) == (before[0] + 1,
                                                              before[1] + 1)


# ------------------------------------------------ the replica mean, ckpts

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dp", [3, 4])
def test_replica_mean_on_card_matches_cpu(cuda_device, dtype, dp):
    """agd's and every_logp's mean: fp32 sums and the product with the
    fp32 reciprocal of dp give the CPU's bits on the card."""
    from repro_torch.core import PackedParams, build_layout
    from repro_torch.core.protocols import _replica_mean
    gen = torch.Generator().manual_seed(dp)
    layout = build_layout({"a": torch.zeros(128 * 1000 + 3),
                           "b": torch.zeros(384)})
    cpu = PackedParams([(torch.randn((dp, n), generator=gen)
                         * 10.0 ** torch.randint(-3, 4, (dp, n),
                                                 generator=gen)).to(dtype)
                        for n in layout.bucket_sizes], layout)
    card = PackedParams([b.to(cuda_device) for b in cpu.buckets], layout)
    _replica_mean(cpu)
    _replica_mean(card)
    torch.cuda.synchronize()
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for c, g in zip(cpu.buckets, card.buckets):
        assert torch.equal(g.cpu().view(ints), c.view(ints))
        assert torch.equal(c, c[:1].expand_as(c))


@pytest.mark.cuda
def test_card_checkpoint_restores_on_cpu(cuda_device, tmp_path):
    """A small model's gossip_async int8 state, trained two steps on the
    card (through the kernels), saved there and restored into a CPU
    template: every tensor, ``step`` and ``t`` bit for bit."""
    import dataclasses

    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.configs import get_config
    from repro_torch.core import PackedParams
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.models import reduced
    from repro_torch.optim import sgd
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=64),
                              param_dtype="bfloat16", compute_dtype="float32")
    opt = sgd(0.1, momentum=0.9)
    proto = dict(protocol="gossip_async", staleness=2, wire_dtype="int8",
                 gossip_subset=0.5)

    def state_on(dev, seed):
        b = make_train_step_bundle(cfg, opt, dp=4, gossip_packed=True,
                                   device=dev, **proto)
        return b, init_train_state(cfg, opt, dp=4, packed=True,
                                   layout=b.layout, seed=seed, device=dev,
                                   inbox=b.protocol.staleness, wire=b.wire)

    bundle, state = state_on(cuda_device, 0)
    before = fused_update.scaled_launches.count
    tr = Trainer(bundle, state, ShardedTokenDataset(
        cfg.vocab, 16, n_shards=4, batch_per_shard=2), log_every=0)
    tr.run(2)
    torch.cuda.synchronize()
    assert fused_update.scaled_launches.count > before
    save_state(str(tmp_path), tr.state, step=2)
    rest, man = restore_state(str(tmp_path), state_on("cpu", 1)[1])
    assert man["step"] == 2 and rest["opt"]["step"] == 2
    assert rest["inbox"]["t"] == tr.state["inbox"]["t"] == 2
    assert (rest["inbox"]["valid"] == tr.state["inbox"]["valid"]).all()

    def tensors(node):
        if isinstance(node, PackedParams):
            yield from node.buckets
        elif isinstance(node, dict):
            for k in sorted(node):
                yield from tensors(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                yield from tensors(v)
        elif isinstance(node, torch.Tensor):
            yield node

    got, want = list(tensors(rest)), list(tensors(tr.state))
    assert len(got) == len(want)
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == w.dtype
        w = w.cpu()
        assert torch.equal(g.view(ints[g.element_size()]),
                           w.view(ints[w.element_size()]))


LEAF_SHAPES = [(4, 3, 5), (4, 130), (4, 2, 7, 11), (4, 28, 128),
               (4, 3, 1000 * 128 + 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LEAF_SHAPES)
def test_mix_kernel_on_leaf_shapes_with_row_alpha(cuda_device, dtype, shape):
    """The per-leaf engine's ``mix_impl``: ``gossip_mix_1d`` on a leaf
    viewed as (rows, -1), lengths not a LANE multiple, one alpha per row
    (zeros on rows other than 0, as a dropped exchange gives), bit for bit
    against the plain version, one launch per leaf."""
    gen = torch.Generator(device=cuda_device).manual_seed(len(shape))
    a = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    b = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    rows = a.view(shape[0], -1)
    for alpha in (0.25, torch.tensor([0.5, 0.0, 0.25, 0.0],
                                     device=cuda_device)):
        want = gossip_mix_plain(rows, b.view(shape[0], -1), alpha)
        got = rows.clone()
        before = gossip_mix.launches.count
        gossip_mix_1d(got, b.view(shape[0], -1), alpha)
        torch.cuda.synchronize()
        assert gossip_mix.launches.count == before + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [0.0, 0.3], ids=["nodrop", "drop30"])
def test_leaf_engines_with_the_kernel_match_the_oracle(cuda_device, drop):
    """On the card: ``make_gossip_mix`` and ``make_async_gossip_mix`` with
    ``mix_impl=gossip_mix_1d`` against ``core.simulate`` (``gossip_mix_sim``
    and ``gossip_mix_sim_delayed_k``, per-row masked alpha) bit for bit in
    fp32 over period + 2 phases; one launch per leaf and step."""
    from repro_torch.core import build_schedule
    from repro_torch.core import simulate as S
    from repro_torch.core.async_gossip import (exchange_ok, init_inbox_ring,
                                               make_async_gossip_mix)
    from repro_torch.core.gossip import make_gossip_mix
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    tree = {f"w{i}": torch.randn(s, generator=gen, device=cuda_device)
            for i, s in enumerate(LEAF_SHAPES[:4])}
    sched = build_schedule(4, seed=2)
    got = {k: v.clone() for k, v in tree.items()}
    want = {k: v.clone() for k, v in tree.items()}
    mix = make_gossip_mix(sched, mix_impl=gossip_mix_1d)
    before = gossip_mix.launches.count
    for t in range(sched.period + 2):
        mix(got, t)
        want = S.gossip_mix_sim(want, sched.recv_from(t))
        torch.cuda.synchronize()
        assert all(torch.equal(got[k], want[k]) for k in tree)
    assert gossip_mix.launches.count == before + (sched.period + 2) * 4
    got = {k: v.clone() for k, v in tree.items()}
    want = {k: v.clone() for k, v in tree.items()}
    ring, wring = init_inbox_ring(got, 2, 4), init_inbox_ring(want, 2, 4)
    amix = make_async_gossip_mix(sched, staleness=2, drop_rate=drop,
                                 drop_seed=1, mix_impl=gossip_mix_1d)
    for t in range(sched.period + 2):
        got, ring = amix(got, ring, t)
        ok = exchange_ok(wring["t"], list(range(4)), 1, drop)
        want, wring = S.gossip_mix_sim_delayed_k(want, wring,
                                                 sched.recv_from(t), 0.5, ok)
        torch.cuda.synchronize()
        assert all(torch.equal(got[k], want[k]) for k in tree)
        assert all(torch.equal(ring["slots"][-1][k], wring["slots"][-1][k])
                   for k in tree)
        assert (ring["valid"] == wring["valid"]).all()


def _shard_local_layout(dtype):
    """Reduced qwen3's shard-local layout under fsdp on mesh (2, 2, 2):
    dp 2 over the pods, 4 shards over (data, model)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import reduced
    from repro_torch.train import make_distribution
    from repro_torch.train.step import _build_packed_layout
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=64),
                              param_dtype=dtype, compute_dtype="float32",
                              dist_mode="fsdp")
    dist = make_distribution(make_smoke_mesh(2, 2, pod=2), "fsdp")
    layout = _build_packed_layout(dist, cfg)
    assert layout.num_shards == 4
    return cfg, dist, layout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shard_local_pack_unpack_on_card_match_cpu(cuda_device, dtype):
    """Pack, unpack and the packed gradient of a shard-local layout on the
    card equal the CPU's bit for bit."""
    from repro_torch.core import PackedParams
    from repro_torch.models import lm_init
    from repro_torch.tree import tree_flatten
    cfg, dist, layout = _shard_local_layout(dtype)
    init = lm_init(cfg, seed=0, device="cpu")
    out = {}
    for dev in ("cpu", cuda_device):
        packed = PackedParams.pack(init, layout, lead=(dist.dp,), device=dev)
        for b in packed.buckets:
            b.requires_grad_(True)
        leaves = tree_flatten(packed.unpack())[0]
        sum((x.float() ** 2).sum() for x in leaves).backward()
        out[str(dev)] = ([b.detach().cpu() for b in packed.buckets],
                         [x.detach().cpu() for x in leaves],
                         [b.grad.cpu() for b in packed.buckets])
    ints = {2: torch.int16, 4: torch.int32}
    for a, b in zip(*(sum(out[k], []) for k in ("cpu", str(cuda_device)))):
        assert torch.equal(a.view(ints[a.element_size()]),
                           b.view(ints[b.element_size()]))


@pytest.mark.cuda
@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_shard_local_fused_step_on_card_matches_cpu(cuda_device, opt_name):
    """One synchronous fused mix+update step over the shard-local buckets
    (dp 2) through the kernels equals the plain versions on the CPU, bit
    for bit."""
    from repro_torch.core import (PackedParams, build_schedule,
                                  make_packed_fused_update)
    from repro_torch.optim import adamw, sgd
    cfg, dist, layout = _shard_local_layout("bfloat16")
    opt = (adamw(1e-3, weight_decay=0.02) if opt_name == "adamw"
           else sgd(0.1, momentum=0.9))
    gen = torch.Generator().manual_seed(7)
    p0 = [torch.randn(dist.dp, n, generator=gen).to(torch.bfloat16)
          for n in layout.bucket_sizes]
    g0 = [torch.randn(dist.dp, n, generator=gen).to(torch.bfloat16)
          for n in layout.bucket_sizes]
    counter = (fused_update.adamw_launches if opt_name == "adamw"
               else fused_update.launches)
    out = {}
    for dev in ("cpu", cuda_device):
        # copies: the engine updates in place, and .to() of a CPU tensor
        # to the CPU is the tensor itself
        params = PackedParams([b.to(dev).clone() for b in p0], layout)
        grads = PackedParams([b.to(dev).clone() for b in g0], layout)
        st = opt.init(params)
        eng = make_packed_fused_update(build_schedule(dist.dp), layout, opt,
                                       mesh=dist.mesh)
        before = counter.count
        for phase in range(2):
            params, st = eng(params, grads, st, phase)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert counter.count == before + 2 * layout.num_buckets
        moms = [st[k].buckets for k in opt.fused_moments]
        out[str(dev)] = [b.cpu() for b in params.buckets] + [
            b.cpu() for m in moms for b in m]
    ints = {2: torch.int16, 4: torch.int32}
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        assert torch.equal(a.view(ints[a.element_size()]),
                           b.view(ints[b.element_size()]))


_RANKS_ON_CARD = r"""
import dataclasses, json, sys
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.configs import get_config
from repro_torch.data import ShardedTokenDataset
from repro_torch.launch.mesh import (destroy_replica_group,
                                     init_replica_group, make_smoke_mesh)
from repro_torch.models import reduced
from repro_torch.optim import sgd
from repro_torch.train import (Trainer, init_train_state, make_distribution,
                               make_train_step_bundle)
from repro_torch.tree import tree_flatten
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=32),
                          param_dtype="float32", compute_dtype="float32",
                          dist_mode="fsdp")
dist = make_distribution(make_smoke_mesh(2, 1), "fsdp")
group = init_replica_group("cuda", dist=dist, backend="gloo", rank=rank,
                           world_size=2, init_method=init, timeout_s=120)
opt = sgd(0.1, momentum=0.9)
bundle = make_train_step_bundle(cfg, opt, dist=dist, gossip_packed=True,
                                device="cuda", group=group, remat=False)
state = init_train_state(cfg, opt, dist=dist, packed=True,
                         layout=bundle.layout, seed=0, device="cuda",
                         group=group)
ds = ShardedTokenDataset(cfg.vocab, 8, n_shards=1, batch_per_shard=4)
tr = Trainer(bundle, state, ds, log_every=0)
hist = tr.run(2)
leaves = [x.detach().cpu().numpy() for x in
          tree_flatten(tr.state["params"].unpack())[0]]
np.savez(out, losses=np.array([h["loss"] for h in hist]),
         **{f"p{i}": x for i, x in enumerate(leaves)})
destroy_replica_group()
print("RANK_OK", rank)
"""


@pytest.mark.cuda
def test_gloo_ranks_on_the_card_match_the_stacked_run(cuda_device,
                                                       tmp_path):
    """Two gloo ranks on the one card (fsdp on (pod 1, data 2, model 1):
    each holds its stretch of every bucket, all-gathers the replica's
    and reduce-scatters the gradient, their CUDA tensors carried by gloo)
    train 2 steps within rtol = atol = 2e-4 of the stacked shard-local run
    on the card."""
    import dataclasses
    import os
    import subprocess
    import sys
    from pathlib import Path

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import reduced
    from repro_torch.optim import sgd
    from repro_torch.train import (Trainer, init_train_state,
                                   make_distribution, make_train_step_bundle)
    from repro_torch.tree import tree_flatten
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANKS_ON_CARD, str(r), init,
         str(tmp_path / f"rank{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in log, log[-3000:]
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=32),
                              param_dtype="float32", compute_dtype="float32",
                              dist_mode="fsdp")
    dist = make_distribution(make_smoke_mesh(2, 1), "fsdp")
    opt = sgd(0.1, momentum=0.9)
    bundle = make_train_step_bundle(cfg, opt, dist=dist, gossip_packed=True,
                                    device=cuda_device, remat=False)
    assert bundle.layout.num_shards == 2 and bundle.fused
    state = init_train_state(cfg, opt, dist=dist, packed=True,
                             layout=bundle.layout, seed=0,
                             device=cuda_device)
    ds = ShardedTokenDataset(cfg.vocab, 8, n_shards=1, batch_per_shard=4)
    tr = Trainer(bundle, state, ds, log_every=0)
    losses = [h["loss"] for h in tr.run(2)]
    want = [x.detach().cpu().numpy()
            for x in tree_flatten(tr.state["params"].unpack())[0]]
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-4,
                                   atol=2e-4)
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[f"p{i}"], w, rtol=2e-4,
                                       atol=2e-4)


SERVE_MODELS = [("qwen3-0.6b", None), ("qwen3-0.6b", 4),
                ("falcon-mamba-7b", None)]
SERVE_IDS = ["qwen3", "qwen3-sw4", "falcon-mamba"]


def _serve_cfg(arch, window):
    import dataclasses
    from repro_torch.configs import get_config, with_sliding_window
    from repro_torch.models import reduced
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              param_dtype="float32", compute_dtype="float32")
    return cfg if window is None else with_sliding_window(cfg, window)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,window", SERVE_MODELS, ids=SERVE_IDS)
def test_serving_on_card_matches_cpu(cuda_device, arch, window):
    """Prefill 12 tokens, then 4 decode steps at device positions: logits
    and every cache leaf on the card against the CPU after each call;
    greedy tokens from the engine equal on both."""
    from repro_torch.models import lm_cache_init, lm_decode, lm_init, lm_prefill
    from repro_torch.serve import ServingEngine
    from repro_torch.tree import tree_flatten, tree_map
    cfg = _serve_cfg(arch, window)
    cpu = lm_init(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    runs = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda w: w.to(dev), cpu)
        t = toks.to(dev)
        logits, cache = lm_prefill(p, cfg, t[:, :12],
                                   lm_cache_init(cfg, 2, 32, device=dev))
        # snapshots: later decode steps write the caches in place
        out = [x.to("cpu", copy=True)
               for x in [logits] + tree_flatten(cache)[0]]
        for i in range(12, 16):
            logits, cache = lm_decode(p, cfg, t[:, i], cache,
                                      torch.full((), i, device=dev))
            out += [x.to("cpu", copy=True)
                    for x in [logits] + tree_flatten(cache)[0]]
        runs[str(dev)] = out
    for a, b in zip(runs["cpu"], runs[str(cuda_device)]):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-4)
    prompts = toks[:, :8].numpy()
    want = ServingEngine(cfg, cpu, 32, device="cpu").generate(prompts, 6)
    got = ServingEngine(cfg, cpu, 32, device=cuda_device).generate(prompts, 6)
    assert (got == want).all()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,window", SERVE_MODELS, ids=SERVE_IDS)
def test_generate_on_card_is_repeatable(cuda_device, arch, window):
    from repro_torch.models import lm_init
    from repro_torch.serve import ServingEngine
    cfg = _serve_cfg(arch, window)
    eng = ServingEngine(cfg, lm_init(cfg, seed=2, device=cuda_device), 64,
                        device=cuda_device)
    prompts = torch.randint(0, cfg.vocab, (3, 9),
                            generator=torch.Generator().manual_seed(3)).numpy()
    first = eng.generate(prompts, 8)
    assert first.shape == (3, 8) and (first == eng.generate(prompts, 8)).all()


@pytest.mark.cuda
def test_profile_rows_from_raw_events_equal_key_averages(cuda_device):
    """``chip_smoke._device_rows`` sums the profiler's raw device events by
    kernel name; on a small profile (products, an activation and the fused
    sweep) its rows equal ``key_averages()``'s: the same kernels, launch
    counts and device time."""
    import importlib.util
    from pathlib import Path

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(512, 512, device=cuda_device, generator=gen)
    p, g, m, b = (torch.randn(4, 1 << 16, device=cuda_device, generator=gen)
                  for _ in range(4))
    fused_sgd_1d(p, g, b, m, lr=0.1)        # built before the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            a = torch.tanh(a @ a * 1e-2)
            fused_sgd_1d(p, g, b, m, lr=0.1)
        torch.cuda.synchronize()
    raw = {k: (ms, n) for k, ms, n in cs._device_rows(prof)}
    avg = {e.key: (e.self_device_time_total / 1e3, e.count)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    assert raw and raw.keys() == avg.keys()
    assert any("sgd" in k for k in raw)
    for k, (ms, n) in raw.items():
        assert n == avg[k][1], k
        assert abs(ms - avg[k][0]) <= 1e-9 + 1e-9 * ms, (k, ms, avg[k])
