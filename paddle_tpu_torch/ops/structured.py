"""Structured-prediction losses, sampling and metric ops: the port of
paddle_tpu/ops/structured.py (reference: paddle/fluid/operators/
nce_op.cc, hierarchical_sigmoid_op.cc, linear_chain_crf_op.cc,
crf_decoding_op.cc, edit_distance_op.cc, warpctc_op.cc, ctc_align_op.cc,
chunk_eval_op.cc, sampling_id_op.cc, metrics/precision_recall_op.cc,
mean_iou_op.cc, modified_huber_loss_op.cc and
positive_negative_pair_op.cc).

Variable-length sequences are padded (B, T, ...) with a SeqLen (B,)
companion, as in the reference package.  The recursions (the CRF's
alpha and Viterbi passes, CTC's alpha, edit distance's DP rows, the
chunk matcher) are Python loops over time of batched tensor ops on the
device, with no host read; gradients come from torch autograd through
them (no hand-written backward).  Compactions (ignored tokens, CTC's
merge) are a cumsum and a scatter on the device, as in the reference.
Viterbi decoding breaks ties toward the lower tag, as the reference's
argmax does.  NCE shares one negative sample set across the batch and
`sampling_id` draws from the op's own generator (ROADMAP C2).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .common import first, opt_in, out


# ---------------------------------------------------------------------------
# NCE
# ---------------------------------------------------------------------------

def nce_negatives(gen, sampler, num_classes, num_neg, device, dist=None):
    """`num_neg` class ids shared by the batch: uniform (0), log-uniform
    (1: P(k) = log(1 + 1/(k+1)) / log(C+1)) or the custom distribution
    `dist` (2).  `gen` None (shape inference on "meta" tensors) gives
    zeros of the right shape."""
    if gen is None:
        return torch.zeros((num_neg,), dtype=torch.int64, device=device)
    if sampler == 1:
        u = torch.rand((num_neg,), generator=gen, device=device)
        neg = torch.exp(u * math.log(float(num_classes + 1))) - 1.0
        return neg.to(torch.int64).clamp(0, num_classes - 1)
    if sampler == 2:
        return torch.multinomial(dist.clamp(min=1e-20), num_neg,
                                 replacement=True, generator=gen)
    return torch.randint(0, num_classes, (num_neg,), generator=gen,
                         device=device)


def nce_probs(classes, sampler, num_classes, dist=None):
    """The sampler's probability of each id in `classes`."""
    if sampler == 1:
        log_c1 = torch.log(torch.tensor(float(num_classes + 1),
                                        device=classes.device))
        return torch.log1p(1.0 / (classes.to(torch.float32) + 1.0)) / log_c1
    if sampler == 2:
        return dist[classes]
    return torch.full(classes.shape, 1.0 / num_classes,
                      device=classes.device)


def nce_cost(x, label, w, b, neg, sampler, num_classes, dist=None,
             sample_weight=None):
    """The NCE logistic objective given the negatives `neg` (S,):
    (Cost (B, 1), SampleLogits (B, num_true + S), SampleLabels).  The op
    draws `neg`; a parity test hands in the reference's (its
    SampleLabels output carries them)."""
    label = label.to(torch.int64)
    if label.dim() == 1:
        label = label[:, None]
    num_true, num_neg = label.shape[1], neg.shape[0]
    neg = neg.to(torch.int64)
    true_logit = torch.einsum("bd,btd->bt", x, w[label])
    neg_logit = x @ w[neg].t()
    if b is not None:
        true_logit = true_logit + b[label]
        neg_logit = neg_logit + b[neg]
    q_true = nce_probs(label, sampler, num_classes, dist)
    q_neg = nce_probs(neg, sampler, num_classes, dist)[None, :]
    true_adj = true_logit - torch.log(num_neg * q_true + 1e-20)
    neg_adj = neg_logit - torch.log(num_neg * q_neg + 1e-20)
    cost = (F.softplus(-true_adj).sum(dim=1)
            + F.softplus(neg_adj).sum(dim=1)) / num_true
    cost = cost[:, None]
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(-1, 1)
    labels = torch.cat([label, neg[None, :].expand(x.shape[0], num_neg)],
                       dim=1).to(torch.int32)
    return cost, torch.cat([true_logit, neg_logit], dim=1), labels


@register_op("nce")
def nce(ctx, ins, attrs):
    """Noise-contrastive estimation (reference nce_op.cc).  Input
    (B, D), Label (B, num_true), Weight (C, D), Bias (C,) and
    CustomDistProbs (C,) optional, SampleWeight optional; attrs
    num_total_classes, num_neg_samples, sampler (0 uniform, 1
    log-uniform, 2 custom).  Cost (B, 1), SampleLogits, SampleLabels."""
    x = first(ins, "Input")
    num_classes = int(attrs["num_total_classes"])
    sampler = int(attrs.get("sampler", 0))
    dist = opt_in(ins, "CustomDistProbs")
    neg = nce_negatives(ctx.rng(), sampler, num_classes,
                        int(attrs.get("num_neg_samples", 10)), x.device,
                        dist)
    cost, logits, labels = nce_cost(
        x, first(ins, "Label"), first(ins, "Weight"), opt_in(ins, "Bias"),
        neg, sampler, num_classes, dist, opt_in(ins, "SampleWeight"))
    return out(Cost=cost, SampleLogits=logits, SampleLabels=labels)


# ---------------------------------------------------------------------------
# Linear-chain CRF
# ---------------------------------------------------------------------------

def _crf_split_transition(transition):
    """Paddle layout (linear_chain_crf_op.cc): row 0 the start weights,
    row 1 the stop weights, rows 2.. the (N, N) transitions."""
    return transition[0], transition[1], transition[2:]


@register_op("linear_chain_crf")
def linear_chain_crf(ctx, ins, attrs):
    """Negative log-likelihood of the tag paths (reference
    linear_chain_crf_op.cc; the minimized cost).  Emission (B, T, N),
    Transition (N+2, N), Label (B, T) or (B, T, 1), SeqLen (B,).
    LogLikelihood (B, 1) and Alpha (B, T, N)."""
    emission = first(ins, "Emission")
    transition = first(ins, "Transition")
    label = first(ins, "Label").to(torch.int64)
    seq_len = first(ins, "SeqLen").to(torch.int64)
    if label.dim() == 3 and label.shape[-1] == 1:
        label = label[..., 0]
    b, t, _ = emission.shape
    start, stop, trans = _crf_split_transition(transition)

    # partition function: the alpha recursion in log space; a row stops
    # moving after its last step
    alpha = start[None, :] + emission[:, 0]
    alphas = [alpha]
    for step in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                              dim=1) + emission[:, step]
        alpha = torch.where((step < seq_len)[:, None], new, alpha)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + stop[None, :], dim=1)

    # the gold path's score
    steps = torch.arange(t, device=emission.device)[None, :]
    valid = steps < seq_len[:, None]
    zero = torch.zeros((), dtype=emission.dtype, device=emission.device)
    em_score = torch.where(
        valid, torch.gather(emission, 2, label[..., None])[..., 0],
        zero).sum(dim=1)
    tr_score = torch.where(steps[:, 1:] < seq_len[:, None],
                           trans[label[:, :-1], label[:, 1:]],
                           zero).sum(dim=1)
    last = (seq_len - 1).clamp(min=0)
    gold = (em_score + tr_score + start[label[:, 0]]
            + stop[label[torch.arange(b, device=label.device), last]])
    return out(LogLikelihood=(log_z - gold)[:, None],
               Alpha=torch.stack(alphas, dim=1))


@register_op("crf_decoding")
def crf_decoding(ctx, ins, attrs):
    """Viterbi decoding (reference crf_decoding_op.cc).  Emission
    (B, T, N), Transition (N+2, N), SeqLen (B,), Label optional.
    ViterbiPath (B, T), 0 past each row's length; with Label, the 0/1
    mask of the positions decoded right."""
    emission = first(ins, "Emission")
    transition = first(ins, "Transition")
    seq_len = first(ins, "SeqLen").to(torch.int64)
    label = opt_in(ins, "Label")
    b, t, _ = emission.shape
    start, stop, trans = _crf_split_transition(transition)

    score = start[None, :] + emission[:, 0]
    backptrs = []
    for step in range(1, t):
        cand = score[:, :, None] + trans[None, :, :]      # (B, i, j)
        # ties: the first maximal index, as jnp.argmax
        backptrs.append(cand.argmax(dim=1))
        score = torch.where((step < seq_len)[:, None],
                            cand.amax(dim=1) + emission[:, step], score)
    tag = (score + stop[None, :]).argmax(dim=1)           # (B,)
    rows = torch.arange(b, device=emission.device)
    tags = [tag]
    for step in range(t - 1, 0, -1):
        prev = backptrs[step - 1][rows, tag]
        tag = torch.where(step < seq_len, prev, tag)
        tags.append(tag)
    path = torch.stack(tags[::-1], dim=1)
    steps = torch.arange(t, device=emission.device)[None, :]
    valid = steps < seq_len[:, None]
    path = torch.where(valid, path, torch.zeros_like(path))
    if label is not None:
        lab = label.to(torch.int64)
        if lab.dim() == 3 and lab.shape[-1] == 1:
            lab = lab[..., 0]
        return out(ViterbiPath=((path == lab) & valid).to(torch.int32))
    return out(ViterbiPath=path.to(torch.int32))


# ---------------------------------------------------------------------------
# Hierarchical sigmoid
# ---------------------------------------------------------------------------

def _simple_code_paths(label, num_classes):
    """The default tree (reference math/matrix_bit_code.h SimpleCode):
    class c's code is c + num_classes; step i of the walk down the
    implicit complete binary tree uses internal node (code >> (i+1)) - 1
    and bit (code >> i) & 1.  (node, bit, mask), each (B, L)."""
    code = label.to(torch.int64) + num_classes
    max_len = max(int(num_classes - 1).bit_length(), 1)
    steps = torch.arange(max_len, device=label.device)
    node = (code[:, None] >> (steps[None, :] + 1)) - 1
    bits = (code[:, None] >> steps[None, :]) & 1
    mask = node >= 0
    return node.clamp(min=0), bits.to(torch.float32), mask.to(torch.float32)


def _custom_code_paths(table, code):
    """A custom tree (reference matrix_bit_code.h CustomCode): row b's
    path is the nodes of PathTable[b] up to the first negative entry,
    its bits PathCode[b]."""
    table = table.to(torch.int64)
    mask = torch.cumprod((table >= 0).to(torch.int64), dim=1)
    return (table.clamp(min=0), code.to(torch.float32),
            mask.to(torch.float32))


@register_op("hierarchical_sigmoid")
def hierarchical_sigmoid(ctx, ins, attrs):
    """reference hierarchical_sigmoid_op.cc.  X (B, D), Label (B,) or
    (B, 1), W (nodes, D), Bias (nodes,) optional; PathTable and PathCode
    (B, L) optional, a custom tree.  Out (B, 1) the cost, PreOut (B, L)
    the path logits; each node costs softplus(z) - bit * z, the sigmoid
    cross entropy of its bit."""
    x, w, b = first(ins, "X"), first(ins, "W"), opt_in(ins, "Bias")
    table = opt_in(ins, "PathTable")
    if table is None:
        label = first(ins, "Label")
        node, bits, mask = _simple_code_paths(
            label.reshape(label.shape[0]), int(attrs["num_classes"]))
    else:
        node, bits, mask = _custom_code_paths(table, first(ins, "PathCode"))
    z = torch.einsum("bd,bld->bl", x, w[node])
    if b is not None:
        z = z + b.reshape(-1)[node]
    cost = (F.softplus(z) - bits * z) * mask
    return out(Out=cost.sum(dim=1, keepdim=True), PreOut=z)


# ---------------------------------------------------------------------------
# Edit distance
# ---------------------------------------------------------------------------

def _steps(t, device):
    return torch.arange(t, device=device)[None, :]


def compact_rows(x, keep, fill):
    """Each row's kept entries shifted left in order, `fill` after them,
    and the count kept: a cumsum and a scatter, on the device."""
    b, t = x.shape
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    n_kept = torch.where(keep, pos + 1, torch.zeros_like(pos)).amax(dim=1)
    res = torch.full((b, t + 1), fill, dtype=x.dtype, device=x.device)
    # a dropped entry lands in the extra column, cut off below
    res = res.scatter(1, torch.where(keep, pos, torch.full_like(pos, t)), x)
    return res[:, :t], n_kept


def _compact_remove(x, lengths, tokens):
    """Every occurrence of `tokens` removed from the padded rows, the
    survivors shifted left and the lengths shrunk (edit_distance's
    ignored_tokens, the reference's pre-filter)."""
    keep = _steps(x.shape[1], x.device) < lengths[:, None]
    for tok in tokens:
        keep = keep & (x != int(tok))
    res, n_kept = compact_rows(x, keep, 0)
    return res, n_kept.to(lengths.dtype)


@register_op("edit_distance")
def edit_distance(ctx, ins, attrs):
    """Levenshtein distance between padded hypothesis and reference id
    sequences (reference edit_distance_op.cc).  Hyps (B, T1), Refs
    (B, T2), HypsLen, RefsLen (B,); attrs normalized (divide by the
    reference's length), ignored_tokens.  Out (B, 1) float32,
    SequenceNum (1,).  One DP row per hypothesis step, all rows of the
    batch at once: with A[0] = i + 1 and A[j+1] = min(row[j] + cost,
    row[j+1] + 1), the new row is new[j] = j + cummin(A - j)[j] (the
    insertion chain), exact in float32; a row past its hypothesis
    length stays as it was."""
    hyp = first(ins, "Hyps").to(torch.int32)
    ref = first(ins, "Refs").to(torch.int32)
    hlen = first(ins, "HypsLen").to(torch.int32)
    rlen = first(ins, "RefsLen").to(torch.int32)
    ignored = attrs.get("ignored_tokens") or []
    if ignored:
        hyp, hlen = _compact_remove(hyp, hlen, ignored)
        ref, rlen = _compact_remove(ref, rlen, ignored)
    b, t1 = hyp.shape
    t2 = ref.shape[1]
    j = torch.arange(t2 + 1, dtype=torch.float32, device=hyp.device)
    row = j.expand(b, t2 + 1)
    for i in range(t1):
        cost = (hyp[:, i:i + 1] != ref).to(torch.float32)
        a = torch.cat([torch.full((b, 1), i + 1.0, device=hyp.device),
                       torch.minimum(row[:, :-1] + cost, row[:, 1:] + 1.0)],
                      dim=1)
        new = j + torch.cummin(a - j, dim=1).values
        row = torch.where((i < hlen)[:, None], new, row)
    idx = rlen.clamp(0, t2).to(torch.int64)[:, None]
    dist = torch.gather(row, 1, idx)
    if attrs.get("normalized", False):
        dist = dist / rlen.to(torch.float32).clamp(min=1.0)[:, None]
    return out(Out=dist, SequenceNum=torch.full((1,), b, dtype=torch.int32,
                                                device=hyp.device))


# ---------------------------------------------------------------------------
# CTC (the warpctc analog) and ctc_align
# ---------------------------------------------------------------------------

# optax.ctc_loss's log(+0): an impossible state's log-probability; an
# alignment that cannot exist gives a large finite loss, not inf
CTC_LOG_EPSILON = -1e5


def ctc_loss(logits, labels, logit_len, label_len, blank):
    """(B,) CTC negative log-likelihoods: the reference's optax.ctc_loss
    (log_softmax inside, log_epsilon -1e5 for impossible states, the
    blank and label alpha recursions of optax's loop body), term by
    term, over the padded batch-major logits (B, T, C) and labels
    (B, U)."""
    b, t, c = logits.shape
    u = labels.shape[1]
    eps = CTC_LOG_EPSILON
    logprobs = torch.log_softmax(logits, dim=-1)
    labels = labels.to(torch.int64)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logits.dtype),
                   (0, 1))
    # a label outside [0, C) emits log-probability 0, as optax's
    # one-hot product gives it
    in_range = (labels >= 0) & (labels < c)
    emit = torch.gather(logprobs, 2, labels.clamp(0, max(c - 1, 0))[
        :, None, :].expand(b, t, u))
    emit = torch.where(in_range[:, None, :], emit, torch.zeros_like(emit))
    phi_lp = logprobs[:, :, blank]
    pad = (_steps(t, logits.device) >= logit_len[:, None]).to(logits.dtype)

    def add_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)],
                         dim=1)

    alpha_phi = F.pad(torch.full((b, u), eps, dtype=logits.dtype,
                                 device=logits.device), (1, 0))
    alpha_emit = torch.full((b, u), eps, dtype=logits.dtype,
                            device=logits.device)
    for s in range(t):
        # emit-to-blank epsilon transition, except onto a repetition
        prev_phi = add_phi(alpha_phi, alpha_emit + eps * repeat)
        lp_emit, lp_phi = emit[:, s], phi_lp[:, s:s + 1]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit,
                                    alpha_emit + lp_emit)
        next_phi = add_phi(prev_phi + lp_phi,
                           alpha_emit + lp_phi + eps * (1.0 - repeat))
        p = pad[:, s:s + 1]
        alpha_emit = p * alpha_emit + (1.0 - p) * next_emit
        alpha_phi = p * alpha_phi + (1.0 - p) * next_phi
    last = add_phi(alpha_phi, alpha_emit)
    n = label_len.to(torch.int64).clamp(0, u)[:, None]
    return -torch.gather(last, 1, n)[:, 0]


@register_op("warpctc")
def warpctc(ctx, ins, attrs):
    """CTC loss (reference warpctc_op.cc; the reference package's
    optax.ctc_loss).  Logits (B, T, C) padded batch-major, Label (B, U),
    LogitsLen, LabelLen (B,); attrs blank (0), norm_by_times (divide by
    the logits' length).  Loss (B, 1); the gradient comes from autograd
    (WarpCTCGrad is not an output)."""
    logits = first(ins, "Logits")
    logit_len = first(ins, "LogitsLen").to(torch.int32)
    loss = ctc_loss(logits, first(ins, "Label"), logit_len,
                    first(ins, "LabelLen").to(torch.int32),
                    int(attrs.get("blank", 0)))
    if attrs.get("norm_by_times", False):
        loss = loss / logit_len.to(loss.dtype).clamp(min=1.0)
    return out(Loss=loss[:, None])


@register_op("ctc_align")
def ctc_align(ctx, ins, attrs):
    """Greedy CTC decode's post-process (reference ctc_align_op.cc):
    repeated tokens merged (merge_repeated), then blanks removed.  Input
    (B, T) ids, SeqLen (B,) optional; Output (B, T) right-padded with
    padding_value, OutLen (B,)."""
    x = first(ins, "Input").to(torch.int32)
    seq_len = opt_in(ins, "SeqLen")
    b, t = x.shape
    blank = int(attrs.get("blank", 0))
    if seq_len is None:
        seq_len = torch.full((b,), t, dtype=torch.int32, device=x.device)
    prev = F.pad(x[:, :-1], (1, 0), value=-1)
    keep = (_steps(t, x.device) < seq_len.to(torch.int32)[:, None]) & \
        (x != blank)
    if attrs.get("merge_repeated", True):
        keep = keep & (x != prev)
    res, n_kept = compact_rows(x, keep, int(attrs.get("padding_value", 0)))
    return out(Output=res, OutLen=n_kept.to(torch.int32))


# ---------------------------------------------------------------------------
# chunk_eval (IOB tagging chunks)
# ---------------------------------------------------------------------------

def _shift(x, fill, back):
    """x moved one step along time, `fill` in the freed slot: back=True
    gives each step its predecessor, False its successor."""
    col = torch.full_like(x[:, :1], fill)
    return torch.cat([col, x[:, :-1]] if back else [x[:, 1:], col], dim=1)


def _iob_begin_end(tags, seq_len, num_chunk_types):
    """begin, end, type and valid markers of IOB tags: tag = 2 * type +
    {B: 0, I: 1}, O = 2 * num_chunk_types (reference chunk_eval_op.h's
    IOB scheme)."""
    valid = _steps(tags.shape[1], tags.device) < seq_len[:, None]
    is_o = tags >= 2 * num_chunk_types
    ctype = torch.where(is_o, torch.full_like(tags, -1),
                        torch.div(tags, 2, rounding_mode="floor"))
    is_b = ~is_o & (torch.remainder(tags, 2) == 0)
    prev_ctype = _shift(ctype, -2, back=True)
    prev_in = _shift(~is_o, False, back=True)
    # a chunk starts at B, or at an I that continues no chunk of its type
    begin = ~is_o & (is_b | ~(prev_in & (prev_ctype == ctype))) & valid
    cont = (_shift(valid, False, back=False)
            & (_shift(ctype, -2, back=False) == ctype)
            & ~_shift(begin, False, back=False))
    end = ~is_o & valid & ~cont
    return begin, end, ctype, valid


@register_op("chunk_eval")
def chunk_eval(ctx, ins, attrs):
    """Chunk-level precision, recall and F1 of IOB sequence tagging
    (reference chunk_eval_op.cc; ChunkEvaluator reads the counts).
    Inference, Label (B, T) or (B, T, 1), SeqLen (B,); attrs
    num_chunk_types, excluded_chunk_types (counted as O on both sides).
    Precision, Recall, F1-Score (1,) float32 and NumInferChunks,
    NumLabelChunks, NumCorrectChunks (1,).  A chunk is correct when
    both sides begin a chunk of its type at its first step, both stay
    inside it and both end at its last step (a broken-I start on one
    side matches a B start on the other)."""
    inf = first(ins, "Inference").to(torch.int32)
    lab = first(ins, "Label").to(torch.int32)
    seq_len = first(ins, "SeqLen").to(torch.int32)
    if inf.dim() == 3:
        inf = inf[..., 0]
    if lab.dim() == 3:
        lab = lab[..., 0]
    nct = int(attrs["num_chunk_types"])
    o_tag = 2 * nct
    for t in attrs.get("excluded_chunk_types") or []:
        inf = torch.where(torch.div(inf, 2, rounding_mode="floor") == int(t),
                          torch.full_like(inf, o_tag), inf)
        lab = torch.where(torch.div(lab, 2, rounding_mode="floor") == int(t),
                          torch.full_like(lab, o_tag), lab)
    ib, ie, it, _ = _iob_begin_end(inf, seq_len, nct)
    lb, le, lt, _ = _iob_begin_end(lab, seq_len, nct)
    num_inf = ib.sum().to(torch.int32)
    num_lab = lb.sum().to(torch.int32)
    both_begin = ib & lb & (it == lt)
    same_in = (it >= 0) & (lt >= 0) & (it == lt) & ~ib & ~lb
    carry = torch.zeros(inf.shape[0], dtype=torch.bool, device=inf.device)
    dones = []
    for s in range(inf.shape[1]):
        matching = both_begin[:, s] | (carry & same_in[:, s])
        dones.append(matching & le[:, s] & ie[:, s])
        carry = matching & ~le[:, s] & ~ie[:, s]
    num_correct = (torch.stack(dones).sum() if dones
                   else num_inf * 0).to(torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=inf.device)
    prec = torch.where(num_inf > 0, num_correct / num_inf, zero)
    rec = torch.where(num_lab > 0, num_correct / num_lab, zero)
    f1 = torch.where(num_correct > 0, 2 * prec * rec / (prec + rec), zero)
    return out(**{"Precision": prec.reshape((1,)),
                  "Recall": rec.reshape((1,)),
                  "F1-Score": f1.reshape((1,)),
                  "NumInferChunks": num_inf.reshape((1,)),
                  "NumLabelChunks": num_lab.reshape((1,)),
                  "NumCorrectChunks": num_correct.reshape((1,))})


# ---------------------------------------------------------------------------
# sampling_id
# ---------------------------------------------------------------------------

@register_op("sampling_id")
def sampling_id(ctx, ins, attrs):
    """A column id drawn from each row's distribution X (reference
    sampling_id_op.cc), from the op's generator."""
    x = first(ins, "X")
    gen = ctx.rng()
    if gen is None:     # shape inference on "meta" tensors
        return out(Out=torch.zeros(x.shape[:-1], dtype=torch.int32,
                                   device=x.device))
    probs = x.clamp(min=1e-20).reshape(-1, x.shape[-1])
    ids = torch.multinomial(probs, 1, generator=gen)
    return out(Out=ids.reshape(x.shape[:-1]).to(torch.int32))


# ---------------------------------------------------------------------------
# Metrics: precision_recall, mean_iou, positive_negative_pair; the
# modified Huber loss
# ---------------------------------------------------------------------------

def _one_hot(idx, n):
    """(len(idx), n) float32 one-hot rows; an id outside [0, n) gives a
    zero row, as jax.nn.one_hot."""
    cls = torch.arange(n, device=idx.device)
    return (idx.to(torch.int64)[:, None] == cls[None, :]).to(torch.float32)


def _pr_metrics(states):
    """macro P, R, F1 and micro P, R, F1 of per-class [TP, FP, TN, FN]."""
    tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]
    zero = torch.zeros((), dtype=torch.float32, device=states.device)

    def ratio(a, b):
        return torch.where(a + b > 0, a / (a + b + 1e-12), zero)

    def f1(p, r):
        return torch.where(p + r > 0, 2 * p * r / (p + r + 1e-12), zero)

    prec, rec = ratio(tp, fp), ratio(tp, fn)
    stp, sfp, sfn = tp.sum(), fp.sum(), fn.sum()
    mp, mr = ratio(stp, sfp), ratio(stp, sfn)
    return torch.stack([prec.mean(), rec.mean(), f1(prec, rec).mean(),
                        mp, mr, f1(mp, mr)])


@register_op("precision_recall")
def precision_recall(ctx, ins, attrs):
    """Multi-class precision, recall and F1, macro and micro averaged
    (reference metrics/precision_recall_op.cc).  MaxProbs and Indices
    (B, 1), or Predictions (B, C); Labels (B, 1); Weights (B, 1)
    optional; StatesInfo (C, 4) optional, the running [TP, FP, TN, FN]
    a class.  BatchMetrics (6,), AccumMetrics (6,), AccumStatesInfo
    (C, 4), metrics in the reference's order: macro P, R, F1, micro P,
    R, F1."""
    idx = opt_in(ins, "Indices")
    if idx is None:
        idx = first(ins, "Predictions").argmax(dim=-1)
    idx = idx.reshape(-1)
    labels = first(ins, "Labels").reshape(-1)
    weights = opt_in(ins, "Weights")
    wt = (torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
          if weights is None else weights.reshape(-1).to(torch.float32))
    c = int(attrs["class_number"])
    pred_1h, lab_1h = _one_hot(idx, c), _one_hot(labels, c)
    correct = (idx.to(torch.int64) == labels.to(torch.int64)).to(
        torch.float32) * wt
    tp = correct @ lab_1h
    fp = wt @ pred_1h - tp
    fn = wt @ lab_1h - tp
    tn = wt.sum() - tp - fp - fn
    batch = torch.stack([tp, fp, tn, fn], dim=1)
    prev = opt_in(ins, "StatesInfo")
    accum = batch if prev is None else batch + prev.to(torch.float32)
    return out(BatchMetrics=_pr_metrics(batch),
               AccumMetrics=_pr_metrics(accum), AccumStatesInfo=accum)


def _class_counts(idx, values, n):
    """(n,) int32 sums of `values` by class id; ids wrap once when
    negative and are dropped outside [0, n), as the reference's
    `.at[].add(mode="drop")`."""
    from .common import fill_index

    i, bad = fill_index(idx, n)
    v = torch.where(bad, torch.zeros_like(values), values).to(torch.int32)
    return torch.zeros((n,), dtype=torch.int32, device=idx.device
                       ).scatter_add(0, i, v)


@register_op("mean_iou")
def mean_iou(ctx, ins, attrs):
    """Mean intersection over union for segmentation (reference
    mean_iou_op.h): a right pixel counts correct[pred]; a wrong one
    counts wrong[label] and wrong[pred]; IoU_c = correct_c / (wrong_c +
    correct_c), averaged over the classes present.  InWrongs,
    InCorrects and InMeanIou, where given, add onto the outputs."""
    pred = first(ins, "Predictions").reshape(-1)
    label = first(ins, "Labels").reshape(-1)
    n = int(attrs["num_classes"])
    match = (pred == label).to(torch.int32)
    miss = 1 - match
    correct = _class_counts(pred, match, n)
    wrong = _class_counts(label, miss, n) + _class_counts(pred, miss, n)
    for prev in ins.get("InCorrects", []):
        correct = correct + prev.to(torch.int32)
    for prev in ins.get("InWrongs", []):
        wrong = wrong + prev.to(torch.int32)
    denom = wrong + correct
    valid = denom > 0
    iou = torch.where(valid, correct / denom.clamp(min=1),
                      torch.zeros((), device=denom.device))
    miou = iou.sum() / valid.sum().to(torch.int32).clamp(min=1)
    for prev in ins.get("InMeanIou", []):
        miou = miou + prev.reshape(())
    return {"OutMeanIou": [miou.reshape(1).to(torch.float32)],
            "OutWrong": [wrong], "OutCorrect": [correct]}


@register_op("modified_huber_loss")
def modified_huber_loss(ctx, ins, attrs):
    """Binary classification's modified Huber loss (reference
    modified_huber_loss_op.cc): labels {0, 1} scaled to {-1, +1}; loss
    max(0, 1 - yf)^2 where yf >= -1, else -4 yf."""
    x = first(ins, "X")
    yf = (2.0 * first(ins, "Y").to(x.dtype) - 1.0) * x
    loss = torch.where(yf >= -1.0, torch.square((1.0 - yf).clamp(min=0.0)),
                       -4.0 * yf)
    return {"Out": [loss.to(x.dtype)], "IntermediateVal": [yf.to(x.dtype)]}


@register_op("positive_negative_pair")
def positive_negative_pair(ctx, ins, attrs):
    """Learning-to-rank pair counts (reference
    positive_negative_pair_op.cc): within each query, the item pairs
    whose score order agrees (positive), disagrees (negative) or ties
    (neutral) with their label order; label ties are skipped.  A Weight
    column weighs a pair by (w_i + w_j) / 2; the Accumulate* inputs add
    onto the counts.  Every pair at once, counted once (upper
    triangle)."""
    score = first(ins, "Score")
    label = first(ins, "Label").reshape(-1).to(torch.float32)
    query = first(ins, "QueryID").reshape(-1)
    weight = opt_in(ins, "Weight")
    s = score[:, int(attrs.get("column", -1))].to(torch.float32)
    n = s.shape[0]
    w = (torch.ones((n,), dtype=torch.float32, device=s.device)
         if weight is None else weight.reshape(-1).to(torch.float32))
    upper = torch.ones((n, n), dtype=torch.bool, device=s.device).triu(1)
    dl = label[:, None] - label[None, :]
    ds = s[:, None] - s[None, :]
    pair_ok = upper & (query[:, None] == query[None, :]) & (dl != 0)
    pw = (w[:, None] + w[None, :]) * 0.5
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    pos = torch.where(pair_ok & (ds * dl > 0), pw, zero).sum()
    neg = torch.where(pair_ok & (ds != 0) & (ds * dl < 0), pw, zero).sum()
    neu = torch.where(pair_ok & (ds == 0), pw, zero).sum()
    accs = [opt_in(ins, f"Accumulate{k}Pair")
            for k in ("Positive", "Negative", "Neutral")]
    pos, neg, neu = (v if a is None else v + a.reshape(())
                     for v, a in zip((pos, neg, neu), accs))
    return {"PositivePair": [pos.reshape(1)],
            "NegativePair": [neg.reshape(1)],
            "NeutralPair": [neu.reshape(1)]}
