"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked `cuda` and skips without an NVIDIA GPU;
the file imports neither jax nor paddle_tpu, so on the GPU machine it
runs without the JAX package (the repo's conftest imports jax, hence
`--noconftest`):

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tolerances: 2e-5 (abs and rel) for float32 operands — both sides compute
in float32 and differ in summation order; the same for bfloat16/int8
pools, which both sides dequantize to the same float32 values.  The
flash kernels' bf16 paths against their bf16 plain versions: O within
2^-6 of max |O| (two bf16 ulps), the gradients within 2^-7 relative
(one ulp; each test states why).  The
vocab-CE kernels are held to 2e-5 of each output's max |reference|
(absolute): their sums run over D, V or N terms in another order.  The
LSTM kernels are held to 1e-4 of each output's max |reference|: their
recurrence compounds float32 differences over T steps.
"""

from __future__ import annotations

import pytest
import torch

from paddle_tpu_torch import CPUPlace, CUDAPlace
from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.kernels import flash_attention as fk
from paddle_tpu_torch.ops.kernels import lstm as lk
from paddle_tpu_torch.ops.kernels import paged_attention as pk
from paddle_tpu_torch.ops.kernels import vocab_ce as vk

pytestmark = pytest.mark.cuda
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _paged(kv_dtype, dev, s=5, h=4, d=64, p=40, page=16, maxp=6, seed=0,
           lengths=None):
    g = torch.Generator().manual_seed(seed)
    hd = h * d
    q = torch.randn(s, hd, generator=g)
    lens = torch.randint(1, page * maxp + 1, (s,), generator=g,
                         dtype=torch.int32)
    lens[0] = 0                                   # an empty slot
    if lengths is not None:
        lens = torch.tensor(lengths, dtype=torch.int32)
    pt = torch.zeros(s, maxp, dtype=torch.int32)
    perm = torch.randperm(p, generator=g)
    for i in range(s):
        used = -(-int(lens[i]) // page)
        pt[i, :used] = perm[i * maxp:i * maxp + used]
    ks = vs = None
    if kv_dtype == torch.int8:
        kc = torch.randint(-127, 128, (p, page, hd), generator=g,
                           dtype=torch.int8)
        vc = torch.randint(-127, 128, (p, page, hd), generator=g,
                           dtype=torch.int8)
        ks = torch.rand(p, page, 1, generator=g) * 0.02
        vs = torch.rand(p, page, 1, generator=g) * 0.02
        for i in range(s):                      # poison past each length
            for t in range(int(lens[i]), -(-int(lens[i]) // page) * page):
                ks[pt[i, t // page], t % page] = float("nan")
                vs[pt[i, t // page], t % page] = float("nan")
    else:
        kc = torch.randn(p, page, hd, generator=g).to(kv_dtype)
        vc = torch.randn(p, page, hd, generator=g).to(kv_dtype)
        for i in range(s):                      # poison past each length
            for t in range(int(lens[i]), -(-int(lens[i]) // page) * page):
                kc[pt[i, t // page], t % page] = 1e3
                vc[pt[i, t // page], t % page] = float("nan")
    to = (lambda x: None if x is None else x.to(dev))
    return [to(x) for x in (q, kc, vc, pt, lens)], h, to(ks), to(vs)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.int8])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_kernel_matches_plain(dev, kv_dtype, d):
    (q, kc, vc, pt, lens), h, ks, vs = _paged(kv_dtype, dev, d=d)
    before = kernels.launch_counts["paged_attention"]
    got = pk.paged_attention(q, kc, vc, pt, lens, n_head=h, k_scales=ks,
                             v_scales=vs)
    torch.cuda.synchronize()
    assert kernels.launch_counts["paged_attention"] == before + 1
    want = pk.paged_attention_plain(q, kc, vc, pt, lens, h, k_scales=ks,
                                    v_scales=vs)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)
    # no atomics: a second run gives the same bits
    assert torch.equal(pk.paged_attention(q, kc, vc, pt, lens, n_head=h,
                                          k_scales=ks, v_scales=vs), got)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.int8])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_kernel_at_split_boundaries(dev, kv_dtype, d):
    """Two splits of 4 pages a slot (64 tokens): lengths 0, exactly one
    split, exactly one page (the second split wholly past the length),
    one past a split, and the full 6 pages; NaN (V, int8 scales) and 1e3
    (K) past each length.  Against the plain version, and the same bits
    twice."""
    (q, kc, vc, pt, lens), h, ks, vs = _paged(
        kv_dtype, dev, d=d, lengths=[0, 64, 16, 65, 96])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = pk.launch_plan(q, kc, pt, h, sms)
    assert plan["n_splits"] > 1, plan

    def kern():
        return pk.paged_attention(q, kc, vc, pt, lens, n_head=h,
                                  k_scales=ks, v_scales=vs)

    got = kern()
    torch.cuda.synchronize()
    want = pk.paged_attention_plain(q, kc, vc, pt, lens, h, k_scales=ks,
                                    v_scales=vs)
    assert torch.isfinite(got).all() and not got[0].any()
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(kern(), got)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_rows_with_plan_rows_are_the_step_rows(dev, kv_dtype):
    """The speculative verify run's batch invariance: each row repeated 5
    times (80 rows on 16 page tables) with plan_rows=16 gives every row
    the bits of the 16-row launch; with the 80 rows' own plan the splits
    differ, and the rows stay within the tolerance."""
    (q, kc, vc, pt, lens), h, _, _ = _paged(kv_dtype, dev, s=16, p=330,
                                            maxp=20, seed=3)
    step = pk.paged_attention(q, kc, vc, pt, lens, n_head=h)
    rep = [x.repeat_interleave(5, dim=0) for x in (q, pt, lens)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert pk.launch_plan(rep[0], kc, rep[1], h, sms) != \
        pk.launch_plan(rep[0], kc, rep[1], h, sms, plan_rows=16)
    folded = pk.paged_attention(rep[0], kc, vc, rep[1], rep[2], n_head=h,
                                plan_rows=16)
    assert torch.equal(folded[::5], step)
    own = pk.paged_attention(rep[0], kc, vc, rep[1], rep[2], n_head=h)
    torch.testing.assert_close(own[::5], step, **TOL)


def test_mul_with_row_block_gives_the_rows_of_a_block_run(dev):
    """`mul` under OpContext.row_block runs its product in blocks, so 80
    rows give each row the bits of a 16-row product (cuBLAS chooses
    another kernel, and summation order, for 80 rows than for 16)."""
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    g = torch.Generator().manual_seed(5)
    x = torch.randn(80, 512, generator=g).to(dev)
    impl = get_op_impl("mul")
    for n_out in (512, 1024, 8192):
        y = torch.randn(512, n_out, generator=g).to(dev)
        ctx = OpContext(device=dev, row_block=16)
        got = impl(ctx, {"X": [x], "Y": [y]}, {})["Out"][0]
        for b in range(5):
            rows = x[b * 16:(b + 1) * 16].contiguous()
            assert torch.equal(got[b * 16:(b + 1) * 16], rows @ y)
        ragged = impl(ctx, {"X": [x[:70]], "Y": [y]}, {})["Out"][0]
        assert torch.equal(ragged, got[:70])


@pytest.mark.parametrize("layout", ["nthd", "nhtd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [17, 64, 130])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_kernel_matches_plain(dev, layout, causal, t, d):
    n, h = 3, 4
    g = torch.Generator().manual_seed(t * d)
    shape = (n, t, h * d) if layout == "nthd" else (n, h, t, d)
    q, k, v = (torch.randn(*shape, generator=g).to(dev) for _ in range(3))
    seq = torch.tensor([t, 0, max(1, t // 3)])        # row 1: all padding
    bias = ((torch.arange(t)[None, :] < seq[:, None]).float() * 1e9
            - 1e9).reshape(n, 1, 1, t).to(dev)
    before = kernels.launch_counts["flash_attention_fwd"]
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, causal,
                                    layout=layout, n_head=h)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention_fwd"] == before + 1
    wo, wl = fk.flash_attention_fwd_plain(q, k, v, bias, None, causal,
                                          layout=layout, n_head=h)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(o, wo, **TOL)
    torch.testing.assert_close(lse, wl, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("q_offset,k_offset", [(37, 5), (60, 0)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_kernel_with_offsets_matches_plain(dev, q_offset, k_offset,
                                                 d):
    """Causal with nonzero q/k offsets at T = 130 (ragged tiles), where
    every query sees at least one key: the forward's per-fragment mask
    and its causal tile skipping."""
    q, k, v, _, bias, h = _bwd_case(dev, "nhtd", 130, d, seed=q_offset + d,
                                    transposed=True)
    args = (q, k, v, bias, None, True, "nhtd", h, q_offset, k_offset)
    o, lse = fk.flash_attention_fwd(*args)
    torch.cuda.synchronize()
    wo, wl = fk.flash_attention_fwd_plain(*args)
    torch.testing.assert_close(o, wo, **TOL)
    torch.testing.assert_close(lse, wl, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("layout,transposed", [("nthd", False),
                                               ("nhtd", True)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_takes_misaligned_operands(dev, layout, transposed,
                                                d):
    """q, k and v one float into their storage: the forward's 16-byte
    copies need 16-byte-aligned rows, so the wrapper hands the kernel
    aligned copies; O comes back in q's layout."""
    q, k, v, _, bias, h = _bwd_case(dev, layout, 100, d, seed=8,
                                    transposed=transposed, misaligned=True)
    assert all(x.data_ptr() % 16 != 0 for x in (q, k, v))
    args = (q, k, v, bias, None, True, layout, h)
    before = kernels.launch_counts["flash_attention_fwd"]
    o, lse = fk.flash_attention_fwd(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention_fwd"] == before + 1
    wo, wl = fk.flash_attention_fwd_plain(*args)
    assert o.shape == wo.shape
    torch.testing.assert_close(o, wo, **TOL)
    torch.testing.assert_close(lse, wl, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_gives_the_same_bits_twice(dev, d):
    """Each block owns its output rows (no atomics), so two forward runs
    on the same inputs agree bit for bit."""
    q, k, v, _, bias, h = _bwd_case(dev, "nhtd", 256, d, h=8, seed=6,
                                    transposed=True)
    first = fk.flash_attention_fwd(q, k, v, bias, None, True, "nhtd", h)
    again = fk.flash_attention_fwd(q, k, v, bias, None, True, "nhtd", h)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _bwd_case(dev, layout, t, d, n=3, h=4, seed=0, transposed=False,
              misaligned=False):
    """q, k, v, key bias, O, lse and a cotangent dO on the card; with
    `transposed`, nhtd operands are transposed views of (N, T, H, D)
    tensors, as the Transformer's reshape + transpose produces them; with
    `misaligned`, q, k, v and dO start one float into their storage, so
    no row of theirs is 16-byte aligned."""
    g = torch.Generator().manual_seed(seed)
    if layout == "nthd":
        shape = (n, t, h * d)
    else:
        shape = (n, t, h, d) if transposed else (n, h, t, d)
    q, k, v, do = (torch.randn(*shape, generator=g).to(dev)
                   for _ in range(4))
    if misaligned:
        q, k, v, do = (torch.empty(x.numel() + 1, device=dev)[1:]
                       .view(shape).copy_(x) for x in (q, k, v, do))
    if transposed:
        q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
    seq = torch.tensor([t, max(1, t // 3), 1])
    bias = ((torch.arange(t)[None, :] < seq[:, None]).float() * 1e9
            - 1e9).reshape(n, 1, 1, t).to(dev)
    return q, k, v, do, bias, h


@pytest.mark.parametrize("layout,transposed", [("nthd", False),
                                               ("nhtd", False),
                                               ("nhtd", True)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [40, 100, 130])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_bwd_kernels_match_plain(dev, layout, transposed, causal, t,
                                       d):
    q, k, v, do, bias, h = _bwd_case(dev, layout, t, d, seed=t + d,
                                     transposed=transposed)
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, causal,
                                    layout=layout, n_head=h)
    dlse = torch.randn(lse.shape, generator=torch.Generator()
                       .manual_seed(t)).to(dev)
    before = dict(kernels.launch_counts)
    got = fk.flash_attention_bwd(q, k, v, bias, o, lse, do, dlse, None,
                                 causal, layout, h)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention_bwd_dkv"] == \
        before["flash_attention_bwd_dkv"] + 1
    assert kernels.launch_counts["flash_attention_bwd_dq"] == \
        before["flash_attention_bwd_dq"] + 1
    want = fk.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, dlse,
                                        None, causal, layout, h)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("q_offset,k_offset", [(37, 5), (0, 40),
                                                (60, 0), (0, 200)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_bwd_kernels_with_offsets_match_plain(dev, q_offset,
                                                    k_offset, d):
    """Causal with nonzero q/k offsets (a continuation, keys ahead of the
    queries, queries ahead of the keys, and keys so far ahead that no
    query sees any: every dK/dV block skips all its q tiles and writes
    zeros) at T = 130, not a multiple of the kernels' tiles: the mask the
    tensor-core kernels form per fragment.
    With an lse cotangent, as the other backward cases: without one, the
    batch row whose only unpadded key takes all the weight has
    dbias = sum(dp - delta) = 0 up to rounding, a sum of noise."""
    q, k, v, do, bias, h = _bwd_case(dev, "nhtd", 130, d, seed=q_offset + d,
                                     transposed=True)
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, True,
                                    layout="nhtd", n_head=h,
                                    q_offset=q_offset, k_offset=k_offset)
    dlse = torch.randn(lse.shape, generator=torch.Generator()
                       .manual_seed(d)).to(dev)
    args = (q, k, v, bias, o, lse, do, dlse, None, True, "nhtd", h,
            q_offset, k_offset)
    got = fk.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    want = fk.flash_attention_bwd_plain(*args)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("layout,transposed", [("nthd", False),
                                               ("nhtd", True)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_kernels_take_misaligned_operands(dev, layout,
                                                    transposed, causal, d):
    """Operands one float into their storage: the kernels' 16-byte
    copies need 16-byte-aligned rows, so the wrapper hands them aligned
    copies; the result still matches the plain backward, in the
    operands' own layout and strides."""
    q, k, v, do, bias, h = _bwd_case(dev, layout, 100, d, seed=7,
                                     transposed=transposed, misaligned=True)
    assert all(x.data_ptr() % 16 != 0 for x in (q, k, v, do))
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, causal,
                                    layout=layout, n_head=h)
    args = (q, k, v, bias, o, lse, do, None, None, causal, layout, h)
    before = dict(kernels.launch_counts)
    got = fk.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention_bwd_dkv"] == \
        before["flash_attention_bwd_dkv"] + 1
    want = fk.flash_attention_bwd_plain(*args)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_kernels_give_the_same_bits_twice(dev, causal, d):
    """Each block owns its dK/dV or dQ rows over the whole sum (no
    atomics), so two runs on the same inputs agree bit for bit."""
    q, k, v, do, bias, h = _bwd_case(dev, "nhtd", 256, d, n=3, h=8,
                                     seed=5, transposed=True)
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, causal,
                                    layout="nhtd", n_head=h)
    args = (q, k, v, bias, o, lse, do, None, None, causal, "nhtd", h)
    first = fk.flash_attention_bwd(*args)
    again = fk.flash_attention_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_autograd_on_card_matches_cpu(dev):
    """FlashAttentionFn end to end: the card's kernels against the CPU's
    plain versions, from the same inputs and cotangent."""
    q, k, v, do, bias, h = _bwd_case(dev, "nhtd", 70, 64, transposed=True)
    grads = []
    for device in (dev, "cpu"):
        xs = [x.detach().to(device).requires_grad_() for x in (q, k, v)]
        o, _ = fk.flash_attention(*xs, bias.to(device), None, True,
                                  "nhtd", h)
        grads.append(torch.autograd.grad(o, xs, do.to(device)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def _bf16_case(dev, layout, t, d, n=3, h=4, seed=0, misaligned=False):
    """The operands of `_bwd_case` (nhtd ones transposed views) in bf16,
    with the key bias in bf16 too, as the AMP policy hands it to the op;
    with `misaligned`, q, k, v and dO start one value (2 bytes) into
    their storage."""
    q, k, v, do, bias, h = _bwd_case(dev, layout, t, d, n=n, h=h,
                                     seed=seed,
                                     transposed=layout == "nhtd")
    q, k, v, do = (x.bfloat16() for x in (q, k, v, do))
    if misaligned:
        def shift(x):
            base = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
            return base[1:].view(x.shape).copy_(x)
        q, k, v, do = (shift(x.contiguous()) for x in (q, k, v, do))
    return q, k, v, do, bias.bfloat16(), h


def _bf16_close(a, b, name, rtol):
    """a within rtol of b (both widened to float32), element by element,
    plus 2^-10 of b's largest magnitude for the elements near 0."""
    a, b = a.float(), b.float()
    torch.testing.assert_close(a, b, rtol=rtol,
                               atol=2 ** -10 * float(b.abs().max()),
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("layout", ["nthd", "nhtd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [17, 130])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_bf16_kernel_matches_plain(dev, layout, causal, t, d):
    """The forward's bf16 path (bf16 mma.sync, P rounded to bf16 before P
    V, O stored bf16) against the bf16 plain version: O within 2^-6 of
    max |O| (two bf16 ulps: the kernel rounds p against its running row
    max, the plain version against the final one, and both round O),
    lse (float32 from exact bf16 products) as for float32 operands."""
    q, k, v, _, bias, h = _bf16_case(dev, layout, t, d, seed=t + d)
    before = kernels.launch_counts["flash_attention_fwd_bf16"]
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, causal,
                                    layout=layout, n_head=h)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention_fwd_bf16"] == before + 1
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    wo, wl = fk.flash_attention_fwd_plain(q, k, v, bias, None, causal,
                                          layout=layout, n_head=h)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    err = float((o.float() - wo.float()).abs().max())
    assert err <= 2 ** -6 * float(wo.float().abs().max()), err
    torch.testing.assert_close(lse, wl, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("layout", ["nthd", "nhtd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [40, 130])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_bf16_bwd_kernels_match_plain(dev, layout, causal, t, d):
    """The backward's bf16 kernels (bf16 tiles, the score products one
    bf16 pass, p and ds split hi + lo for two passes of the second
    products, float32 sums, dQ, dK and dV stored bf16) against the bf16
    plain backward, from the kernel's own bf16 O: each gradient within
    2^-7 relative (one bf16 ulp: both are float32-accurate and round
    once; tests/test_torch_flash_backward.py emulates the split), the
    bf16 bias gradient the same."""
    q, k, v, do, bias, h = _bf16_case(dev, layout, t, d, seed=t * d)
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, causal,
                                    layout=layout, n_head=h)
    dlse = torch.randn(lse.shape, generator=torch.Generator()
                       .manual_seed(t)).to(dev)
    before = dict(kernels.launch_counts)
    got = fk.flash_attention_bwd(q, k, v, bias, o, lse, do, dlse, None,
                                 causal, layout, h)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dkv_bf16",
                 "flash_attention_bwd_dq_bf16"):
        assert kernels.launch_counts[name] == before[name] + 1, name
    want = fk.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, dlse,
                                        None, causal, layout, h)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert torch.isfinite(a.float()).all(), name
        _bf16_close(a, b, name, 2 ** -7)


@pytest.mark.parametrize("q_offset,k_offset", [(37, 5), (0, 40),
                                                (60, 0), (0, 200)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_bf16_bwd_kernels_with_offsets_match_plain(dev, q_offset,
                                                         k_offset, d):
    """The bf16 kernels under a causal mask with nonzero q/k offsets (ring
    attention's use) at T = 130, with an lse cotangent: the mask formed
    per fragment on the bf16 path, and dK/dV blocks that skip every q
    tile (0/200: no query sees any key) writing zeros."""
    q, k, v, do, bias, h = _bf16_case(dev, "nhtd", 130, d,
                                      seed=q_offset + d)
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, True, "nhtd", h,
                                    q_offset, k_offset)
    dlse = torch.randn(lse.shape, generator=torch.Generator()
                       .manual_seed(d)).to(dev)
    args = (q, k, v, bias, o, lse, do, dlse, None, True, "nhtd", h,
            q_offset, k_offset)
    got = fk.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    want = fk.flash_attention_bwd_plain(*args)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert torch.isfinite(a.float()).all(), name
        _bf16_close(a, b, name, 2 ** -7)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [100, 200])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_bf16_bwd_kernels_dlse_and_dbias_match_plain(dev, causal, t,
                                                           d):
    """T not a multiple of the kernels' 64-row tiles, a nonzero lse
    cotangent, and the key bias's gradient (float32 in the kernel, summed
    over heads, rounded to the bias's bf16) against the plain one; with
    need_dbias=False the kernels write no bias gradient and the other
    three keep their bits."""
    q, k, v, do, bias, h = _bf16_case(dev, "nthd", t, d, seed=t + d)
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, causal, "nthd", h)
    dlse = torch.randn(lse.shape, generator=torch.Generator()
                       .manual_seed(t + 1)).to(dev)
    args = (q, k, v, bias, o, lse, do, dlse, None, causal, "nthd", h)
    got = fk.flash_attention_bwd(*args, need_dbias=True)
    torch.cuda.synchronize()
    want = fk.flash_attention_bwd_plain(*args)
    assert got[3].dtype == torch.bfloat16 and got[3].shape == bias.shape
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert torch.isfinite(a.float()).all(), name
        _bf16_close(a, b, name, 2 ** -7)
    plain = fk.flash_attention_bwd(*args, need_dbias=False)
    assert plain[3] is None
    assert all(torch.equal(a, b) for a, b in zip(plain[:3], got[:3]))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bf16_bwd_kernels_give_the_same_bits_twice(dev, causal, d):
    """Each bf16 block owns its dK/dV or dQ rows over the whole sum (no
    atomics), so two runs on the same inputs agree bit for bit."""
    q, k, v, do, bias, h = _bf16_case(dev, "nhtd", 256, d, h=8, seed=5)
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, causal, "nhtd", h)
    args = (q, k, v, bias, o, lse, do, None, None, causal, "nhtd", h)
    first = fk.flash_attention_bwd(*args)
    again = fk.flash_attention_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("refused", ["dkv", "dq"])
def test_flash_bf16_bwd_refused_launch_raises(dev, monkeypatch, refused):
    """The bf16 entry points refuse rows that are not 16-byte aligned
    (cudaErrorMisalignedAddress, 716) and head dims outside {32, 64, 128}
    (cudaErrorInvalidValue, 1) before launching anything, and a refused
    launch raises in the wrapper, uncounted, with no fallback."""
    import ctypes

    q, k, v, do, bias, h = _bf16_case(dev, "nhtd", 64, 64, seed=2)
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, True, "nhtd", h)
    lib = fk._bind_bwd()
    name = f"flash_attention_bwd_{refused}_bf16"
    outs = (3 if refused == "dkv" else 1) * [q.data_ptr()]
    strides = (ctypes.c_int64 * 24)(*[8] * 24)
    for ptr, d, rc in ((q.data_ptr() + 2, 64, 716), (q.data_ptr(), 96, 1)):
        assert getattr(lib, name + "_launch")(
            ptr, *[q.data_ptr()] * 4, lse.data_ptr(), None, None, *outs, 3,
            h, d, 64, 64, strides, 0.125, 1, 0, 0, dev.index or 0,
            fk._stream(q)) == rc

    class Refusing:
        def __getattr__(self, attr):
            if attr == name + "_launch":
                return lambda *args: 716
            return getattr(lib, attr)

    monkeypatch.setattr(fk, "_bind_bwd", Refusing)
    before = dict(kernels.launch_counts)
    with pytest.raises(RuntimeError, match="CUDA error 716"):
        fk.flash_attention_bwd(q, k, v, bias, o, lse, do, None, None, True,
                               "nhtd", h)
    assert kernels.launch_counts[name] == before[name]


@pytest.mark.parametrize("layout", ["nthd", "nhtd"])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bf16_kernels_take_misaligned_operands(dev, layout, d):
    """bf16 operands one value into their storage: the wrapper hands the
    kernels aligned copies, and forward and backward still match their
    plain versions."""
    q, k, v, do, bias, h = _bf16_case(dev, layout, 100, d, seed=3,
                                      misaligned=True)
    assert all(x.data_ptr() % 16 != 0 for x in (q, k, v, do))
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, True, layout, h)
    wo, _ = fk.flash_attention_fwd_plain(q, k, v, bias, None, True,
                                         layout, h)
    assert float((o.float() - wo.float()).abs().max()) <= \
        2 ** -6 * float(wo.float().abs().max())
    got = fk.flash_attention_bwd(q, k, v, bias, o, lse, do, None, None,
                                 True, layout, h)
    torch.cuda.synchronize()
    want = fk.flash_attention_bwd_plain(q, k, v, bias, o, lse, do, None,
                                        None, True, layout, h)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        _bf16_close(a, b, name, 2 ** -7)


def test_flash_bf16_autograd_on_card_matches_cpu(dev):
    """FlashAttentionFn on bf16 operands: the card's bf16 kernels against
    the CPU's bf16 plain versions, from the same inputs and cotangent;
    gradients come back bf16.  The forward's O on the two devices may
    differ by an ulp, and the backward's delta reads each side's own O,
    so the gradients are held to 2^-5 relative."""
    q, k, v, do, bias, h = _bf16_case(dev, "nhtd", 70, 64)
    grads = []
    for device in (dev, "cpu"):
        xs = [x.detach().to(device).requires_grad_() for x in (q, k, v)]
        o, _ = fk.flash_attention(*xs, bias.to(device), None, True,
                                  "nhtd", h)
        grads.append(torch.autograd.grad(o, xs, do.to(device)))
    for name, a, b in zip("qkv", *grads):
        assert a.dtype == torch.bfloat16, name
        _bf16_close(a.cpu(), b, "d" + name, 2 ** -5)


def test_kernels_refuse_what_they_do_not_take(dev):
    (q, kc, vc, pt, lens), h, _, _ = _paged(torch.float32, dev)
    with pytest.raises(TypeError):
        pk.paged_attention(q, kc, vc, pt.to(torch.int64), lens, n_head=h)
    qf = torch.zeros(2, 8, 64, device=dev)
    with pytest.raises(NotImplementedError):
        fk.flash_attention_fwd(qf, qf, qf, torch.zeros(1, 1, 8, 8,
                                                       device=dev),
                               None, True, layout="nthd", n_head=1)
    with pytest.raises(TypeError, match="all float32 or all bf16"):
        fk.flash_attention_fwd(qf.bfloat16(), qf, qf, None, None, True,
                               layout="nthd", n_head=1)
    q96 = torch.zeros(2, 8, 96, device=dev)
    with pytest.raises(ValueError, match="head dim 96"):
        fk.flash_attention_fwd(q96, q96, q96, None, None, True,
                               layout="nthd", n_head=1)


def test_engine_on_cuda_matches_engine_on_cpu(dev):
    """A short float32-KV stream: the same tokens from the card (through
    both kernels) as from the CPU (plain versions)."""
    from paddle_tpu_torch.convert import params_from_arrays
    from paddle_tpu_torch.models.decoder_lm import DecoderLM, make_prompts
    from paddle_tpu_torch.serving.decode import DecodeConfig, DecodeEngine

    lm = DecoderLM(vocab_size=64, n_layer=2, n_head=2, d_model=64,
                   d_inner=128, kv_dtype="float32", seed=3)
    scope = lm.init_params(place=CPUPlace())
    arrays = {n: v.numpy() for n, v in scope.vars.items()
              if isinstance(v, torch.Tensor)}
    cfg = dict(num_slots=2, page_size=4, max_len=40, num_pages=20,
               prefill_buckets=(8, 16), decode_chunk=4,
               kv_dtype="float32")
    prompts = make_prompts(4, 64, min_len=3, max_len=14, seed=1)
    outs = []
    for place, device in ((CPUPlace(), "cpu"), (CUDAPlace(0), dev)):
        eng = DecodeEngine(lm, DecodeConfig(**cfg), place=place,
                           params=params_from_arrays(arrays, device))
        eng.start()
        outs.append([eng.submit(p, max_new_tokens=6).result(120).tolist()
                     for p in prompts])
        eng.close()
    assert outs[0] == outs[1]


def _vocab_case(dev, n, d, v, seed):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, d, generator=g).to(dev)
    w = (torch.randn(d, v, generator=g) * 0.05).to(dev)
    lbl = torch.randint(0, v, (n,), generator=g, dtype=torch.int32).to(dev)
    cot = torch.randn(n, generator=g)
    cot[::4] = 0.0                               # masked tokens
    return h, w, lbl, cot.to(dev)


def _close_to_max(a, b, name, tol=2e-5):
    assert torch.isfinite(a).all(), name
    err = float((a - b).abs().max())
    assert err <= tol * max(float(b.abs().max()), 1.0), (name, err)


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("n,d,v", [(1000, 512, 1003), (70, 64, 130),
                                   (5, 24, 7), (999, 100, 1001),
                                   (999, 61, 1001)])
def test_vocab_ce_kernels_match_plain(dev, n, d, v, eps):
    h, w, lbl, cot = _vocab_case(dev, n, d, v, seed=n + v)
    before = dict(kernels.launch_counts)
    got = vk.vocab_ce_fwd(h, w, lbl)
    torch.cuda.synchronize()
    for name, a, b in zip(("lse", "z_label", "z_sum"), got,
                          vk.vocab_ce_fwd_plain(h, w, lbl)):
        _close_to_max(a, b, name)
    dh, dw = vk.vocab_ce_bwd(h, w, lbl, got[0], cot, eps)
    torch.cuda.synchronize()
    want = vk.vocab_ce_bwd_plain(h, w, lbl, got[0], cot, eps)
    _close_to_max(dh, want[0], "dh")
    _close_to_max(dw, want[1], "dw")
    for k in ("vocab_ce_fwd", "vocab_ce_dh", "vocab_ce_dw"):
        assert kernels.launch_counts[k] == before[k] + 1, k
    # no atomics: a second run gives the same bits
    again = vk.vocab_ce_bwd(h, w, lbl, got[0], cot, eps)
    assert torch.equal(again[0], dh) and torch.equal(again[1], dw)


@pytest.mark.parametrize("n,d,v", [(1000, 512, 1003), (999, 61, 1001)])
def test_vocab_ce_bwd_under_loss_scaling_matches_unscaled(dev, n, d, v):
    """Dynamic loss scaling (resilience/guard.py) reaches the dh and dW
    kernels through their cotangent: with g * 2^15, then unscaled by
    2^-15, dh and dW hold the unscaled kernels' output within the
    vocab-CE tolerance (a power-of-two scale shifts exponents only, so
    they are expected bit-equal) and overflow nowhere."""
    h, w, lbl, cot = _vocab_case(dev, n, d, v, seed=n + 3)
    lse = vk.vocab_ce_fwd(h, w, lbl)[0]
    scale = torch.tensor(2.0 ** 15, device=dev)
    dh, dw = vk.vocab_ce_bwd(h, w, lbl, lse, cot, 0.1)
    sdh, sdw = vk.vocab_ce_bwd(h, w, lbl, lse, cot * scale, 0.1)
    torch.cuda.synchronize()
    for name, scaled, plain in (("dh", sdh, dh), ("dw", sdw, dw)):
        assert torch.isfinite(scaled).all(), name
        _close_to_max(scaled * (1.0 / scale), plain, name)


@pytest.mark.parametrize("n,d,v", [(1000, 512, 1003), (999, 61, 1001),
                                   (999, 100, 1001)])
def test_vocab_ce_fwd_labels_outside_the_vocabulary(dev, n, d, v):
    """Labels outside [0, V) select no logit in the forward kernel: its
    z_label is NEG there, as the plain version's; lse and z_sum do not
    depend on the label; and two runs give the same bits."""
    h, w, lbl, _ = _vocab_case(dev, n, d, v, seed=n + d)
    lbl[::5], lbl[1::5] = -1, v + 7
    got = vk.vocab_ce_fwd(h, w, lbl)
    torch.cuda.synchronize()
    want = vk.vocab_ce_fwd_plain(h, w, lbl)
    bad = (lbl < 0) | (lbl >= v)
    assert torch.equal(got[1][bad], want[1][bad])
    _close_to_max(got[1][~bad], want[1][~bad], "z_label")
    for name, a, b in zip(("lse", "z_sum"), got[::2], want[::2]):
        _close_to_max(a, b, name)
    again = vk.vocab_ce_fwd(h, w, lbl)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_vocab_ce_autograd_on_card_matches_cpu(dev):
    """VocabCEFn forward + backward: the card's kernels against the CPU's
    plain versions, with out-of-range labels clamped on both."""
    h, w, lbl, cot = _vocab_case(dev, 300, 128, 517, seed=9)
    lbl = lbl.long()
    lbl[:2] = torch.tensor([-3, 517])
    out = []
    for device in (dev, "cpu"):
        hh, ww = (x.detach().to(device).requires_grad_() for x in (h, w))
        loss = vk.fused_vocab_ce(hh, ww, lbl.to(device), 0.1)
        out.append((loss, *torch.autograd.grad(loss, (hh, ww),
                                               cot.to(device))))
    for name, a, b in zip(("loss", "dh", "dw"), *out):
        _close_to_max(a.detach().cpu(), b.detach(), name)
    with pytest.raises(NotImplementedError, match="bf16"):
        vk.fused_vocab_ce(h.to(torch.bfloat16), w.to(torch.bfloat16), lbl)


def test_vocab_ce_filled_labels_on_card_match_cpu(dev):
    """The op's use_pallas=False labels: -1 wraps, out-of-range rows give
    a NaN loss and select no logit in the kernels, on card and CPU."""
    h, w, lbl, cot = _vocab_case(dev, 200, 100, 301, seed=4)
    lbl = lbl.long()
    lbl[:3] = torch.tensor([-1, 301, -302])
    out = []
    for device in (dev, "cpu"):
        hh, ww = (x.detach().to(device).requires_grad_() for x in (h, w))
        loss = vk.fused_vocab_ce(hh, ww, lbl.to(device), 0.1,
                                 fill_labels=True)
        out.append((loss, *torch.autograd.grad(loss, (hh, ww),
                                               cot.to(device))))
    card, cpu = out
    assert torch.isnan(card[0][1:3]).all() and torch.isfinite(card[0][0])
    _close_to_max(card[0].detach().cpu()[3:], cpu[0].detach()[3:], "loss")
    for name, a, b in zip(("dh", "dw"), card[1:], cpu[1:]):
        _close_to_max(a.detach().cpu(), b.detach(), name)


def _lstm_case(dev, t, n, h, seed):
    g = torch.Generator().manual_seed(seed)
    xs = (torch.randn(t, n, 4 * h, generator=g) * 0.5).to(dev)
    w = (torch.randn(h, 4 * h, generator=g) * h ** -0.5).to(dev)
    h0 = (torch.randn(n, h, generator=g) * 0.3).to(dev)
    c0 = (torch.randn(n, h, generator=g) * 0.3).to(dev)
    sl = torch.randint(max(t // 2, 1), t + 1, (n,), generator=g,
                       dtype=torch.int32)
    sl[0], sl[-1] = 0, 1                         # an empty and a 1-step row
    dhs = torch.randn(t, n, h, generator=g).to(dev)
    dcs = torch.randn(t, n, h, generator=g).to(dev)
    return (xs, w, h0, c0, sl.to(dev)), (dhs, dcs)


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("t,n,h", [(7, 5, 24), (3, 130, 8), (33, 64, 132),
                                   (16, 128, 512)])
def test_lstm_kernels_match_plain(dev, t, n, h, rev):
    ops, cots = _lstm_case(dev, t, n, h, seed=t + n + h)
    before = dict(kernels.launch_counts)
    hs, cs = lk.lstm_fwd(*ops, rev)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in
               zip(lk.lstm_fwd(*ops, rev), (hs, cs)))
    for name, a, b in zip(("hs", "cs"), (hs, cs),
                          lk.lstm_fwd_plain(*ops, rev)):
        _close_to_max(a, b, name, tol=1e-4)
    got = lk.lstm_bwd(*ops, hs, cs, *cots, rev)
    torch.cuda.synchronize()
    want = lk.lstm_bwd_plain(*ops, hs, cs, *cots, rev)
    for name, a, b in zip(("dxs", "dw", "dh0", "dc0"), got, want):
        _close_to_max(a, b, name, tol=1e-4)
    for k, n_runs in (("lstm_fwd", 2), ("lstm_bwd", 1)):
        assert kernels.launch_counts[k] == before[k] + n_runs, k
    # no atomics: a second run gives the same bits
    again = lk.lstm_bwd(*ops, hs, cs, *cots, rev)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("t,n,h,lengths,rev", [
    (5, 300, 512, None, False),      # 5 row tiles, the last ragged
    (5, 300, 512, None, True),
    (1, 1, 512, None, False),        # one row, one step
    (6, 3, 4, None, False),          # H = 4: half a block of 8 units
    (7, 9, 40, [0] * 9, False),      # every row frozen
    (7, 9, 40, [0] * 9, True),
], ids=["N300", "N300-rev", "N1-T1", "H4", "frozen", "frozen-rev"])
def test_lstm_bwd_kernel_edge_cases(dev, t, n, h, lengths, rev):
    """The backward kernel against its plain version where its tiling is
    ragged or idle: several 64-row tiles over the two row groups, one
    row, a block with units past H, and rows that never step (dg zero,
    the carries passed through).  The forward kernel, which shares the
    tiling, against its plain version there, and the same bits twice."""
    ops, cots = _lstm_case(dev, t, n, h, seed=t * n + h)
    if lengths is not None:
        ops = (*ops[:4], torch.tensor(lengths, dtype=torch.int32,
                                      device=dev))
    hs, cs = lk.lstm_fwd(*ops, rev)
    for name, a, b in zip(("hs", "cs"), (hs, cs),
                          lk.lstm_fwd_plain(*ops, rev)):
        _close_to_max(a, b, name, tol=1e-4)
    assert all(torch.equal(a, b) for a, b in
               zip(lk.lstm_fwd(*ops, rev), (hs, cs)))
    got = lk.lstm_bwd(*ops, hs, cs, *cots, rev)
    torch.cuda.synchronize()
    want = lk.lstm_bwd_plain(*ops, hs, cs, *cots, rev)
    for name, a, b in zip(("dxs", "dw", "dh0", "dc0"), got, want):
        _close_to_max(a, b, name, tol=1e-4)
    if lengths is not None:
        assert not got[0].any() and not got[1].any()
    again = lk.lstm_bwd(*ops, hs, cs, *cots, rev)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_fused_lstm_autograd_on_card_matches_cpu(dev):
    """fused_lstm forward + backward through LSTMFn: the card's kernels
    against the CPU's plain versions, batch-major and reversed."""
    (xs, w, h0, c0, sl), (dhs, dcs) = _lstm_case(dev, 12, 9, 40, seed=2)
    out = []
    for device in (dev, "cpu"):
        leaves = [x.detach().transpose(0, 1).to(device).requires_grad_()
                  if x is xs else x.detach().to(device).requires_grad_()
                  for x in (xs, w, h0, c0)]
        hid, cell, last_h, last_c = lk.fused_lstm(
            *leaves, sl.to(device), is_reverse=True)
        loss = (hid * dhs.transpose(0, 1).to(device)).sum() + \
            (cell * dcs.transpose(0, 1).to(device)).sum() + \
            last_h.sum() + 0.5 * last_c.sum()
        out.append((hid, cell, last_h, last_c,
                    *torch.autograd.grad(loss, leaves)))
    names = ("hidden", "cell", "last_h", "last_c", "dx", "dw", "dh0", "dc0")
    for name, a, b in zip(names, *out):
        _close_to_max(a.detach().cpu(), b.detach(), name, tol=1e-4)


def test_lstm_kernels_refuse_what_they_do_not_take(dev):
    (xs, w, h0, c0, sl), _ = _lstm_case(dev, 4, 3, 8, seed=1)
    with pytest.raises(NotImplementedError, match="bf16"):
        lk.lstm_fwd(xs.bfloat16(), w.bfloat16(), h0.bfloat16(),
                    c0.bfloat16(), sl)
    wide = 516
    with pytest.raises(ValueError, match="at most 512"):
        lk.lstm_fwd(torch.zeros(2, 3, 4 * wide, device=dev),
                    torch.zeros(wide, 4 * wide, device=dev),
                    torch.zeros(3, wide, device=dev),
                    torch.zeros(3, wide, device=dev),
                    torch.zeros(3, dtype=torch.int32, device=dev))
