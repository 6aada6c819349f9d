"""Structured-prediction and sampling losses: the port of
paddle_tpu/ops/structured.py `nce`, `linear_chain_crf` and
`crf_decoding` (reference: paddle/fluid/operators/nce_op.cc,
linear_chain_crf_op.cc, crf_decoding_op.cc).

Variable-length sequences are padded (B, T, ...) with a SeqLen (B,)
companion, as in the reference package.  The CRF's log-likelihood is
the forward (alpha) recursion in log space, a Python loop over time on
the device; its gradient comes from torch autograd through that
recursion (the reference's linear_chain_crf_grad beta recursion is not
needed).  Viterbi decoding breaks ties toward the lower tag, as the
reference's argmax does (torch.argmax returns the first maximal index).
NCE shares one negative sample set across the batch, as the reference
package does, drawn from the op's own generator.
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
