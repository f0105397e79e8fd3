"""The plain 3-layer GAT (Veličković et al., arXiv:1710.10903) at its PPI
configuration: forward, masked NLL and gradients in plain PyTorch,
float32 unless the precision asks for less.

A layer of H heads of C features (PyG ``GATConv``):

  xw      = x W                                   (N, H·C), no bias
  s_src   = Σ_c xw[:, h, c] a_src[h, c],  s_dst likewise     (N, H)
  entries = every edge (dst, src) that is not a self loop, each duplicate
            one, and one self loop a node
  α       = softmax over a row's entries of LeakyReLU_0.2(s_dst[dst] +
            s_src[src]), head by head
  out[i]  = Σ_{entries (i, j)} α xw[j], head by head; the heads
            concatenated (layers 1, 2) or averaged (layer 3); + bias

  h1 = elu(conv1(x));  h2 = elu(conv2(h1) + h1);  lp = log_softmax(conv3(h2))

The attention is an autograd Function written out here (its backward the
textbook softmax gradient, α (∂α − Σ_row α ∂α), not the port's); the rest
is torch's autograd over plain operations.  Every sum over a row's or a
column's entries (the softmax's max and sum, the weighted sums, the
scores' gradients) is taken by torch's reductions over ``plain.Adjacency``'s
padded blocks, not by scattered adds: a hub of 10⁵ entries added one by
one in float32 would carry more rounding than the program.  ``dense_loss``
is the same model over a dense adjacency, for the test against torch's
autograd.  Nothing here imports the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .plain import FP32, Adjacency, Precision, lane_fault, round_tf32

BLOCK_ELEMS = 1 << 28


def parameters(cfg: dict, num_features: int, num_classes: int):
    """The layout of the port's ``nn.models.GAT`` state_dict, with the law
    each tensor is drawn from (PyG's: Glorot's uniform, zero biases)."""
    c = cfg["hidden"]
    h1, h2, h3 = cfg["heads"]
    out = []
    for name, fan_in, heads, width, bias in (
            ("conv1", num_features, h1, c, h1 * c),
            ("conv2", h1 * c, h2, c, h2 * c),
            ("conv3", h2 * c, h3, num_classes, num_classes)):
        out += [(f"{name}.lin.kernel", (fan_in, heads * width),
                 "glorot_uniform"),
                (f"{name}.att_src", (heads, width), "glorot_uniform"),
                (f"{name}.att_dst", (heads, width), "glorot_uniform"),
                (f"{name}.bias", (bias,), "zeros")]
    return out


def entries(edge_index: torch.Tensor, n: int):
    """(dst, src) int64 of the attention: the edge list ``[src; dst]``
    without its self loops, then one self loop a node."""
    src, dst = edge_index[0].long(), edge_index[1].long()
    keep = src != dst
    loops = torch.arange(n, device=src.device)
    return torch.cat([dst[keep], loops]), torch.cat([src[keep], loops])


class Entries:
    """The attention's entries sorted by (dst, src), with their rows
    (``a``, dst) and columns (``at``, src) as ``Adjacency`` blocks, and
    ``to_t``, the entries in the order of ``at``."""

    def __init__(self, edge_index: torch.Tensor, n: int):
        dst, src = entries(edge_index, n)
        order = torch.sort(dst * n + src, stable=True).indices
        self.dst, self.src, self.n = dst[order], src[order], n
        self.a = Adjacency(self.dst, self.src, None, n, n)
        self.to_t = torch.sort(self.src * n + self.dst, stable=True).indices
        self.at = Adjacency(self.src[self.to_t], self.dst[self.to_t], None,
                            n, n)


def _row_sum(adj: Adjacency, v: torch.Tensor, amax: bool = False):
    """Σ (or the max) over each row's entries of v (nnz, H), in the
    adjacency's order; every row of the attention has an entry."""
    pad = float("-inf") if amax else 0.0
    vp = torch.cat([v, v.new_full((1, v.shape[1]), pad)])
    out = v.new_full((adj.num_rows, v.shape[1]), pad)
    for rr, pos, f0, f1 in adj._blocks(v.shape[1]):
        blk = vp[pos, f0:f1]
        out[rr, f0:f1] = blk.amax(1) if amax else blk.sum(1)
    return out


def _weighted_sum(adj: Adjacency, alpha: torch.Tensor, x: torch.Tensor):
    """out[r] = Σ over row r's entries e of α[e, h] x[col e, head h],
    (rows, H·C), α in the adjacency's order."""
    h = alpha.shape[1]
    k = x.shape[1]
    xp = torch.cat([x, x.new_zeros(1, k)])
    ap = torch.cat([alpha, alpha.new_zeros(1, h)])
    head = torch.arange(k, device=x.device) // (k // h)
    out = x.new_zeros(adj.num_rows, k)
    for rr, pos, f0, f1 in adj._blocks(k):
        w = ap[pos][:, :, head[f0:f1]]
        out[rr, f0:f1] = (w * xp[:, f0:f1][adj.col[pos]]).sum(1)
    return out


def _round(t: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "tf32":
        return round_tf32(t)
    if fmt != "float32":
        raise ValueError(f"unknown aggregation precision {fmt!r}")
    return t


def _blocks(num: int, width: int):
    step = max(1, BLOCK_ELEMS // max(width, 1))
    return [slice(e0, min(e0 + step, num)) for e0 in range(0, num, step)]


class _TF32MM(torch.autograd.Function):
    """a @ b with both operands rounded to TF32 in every product, forward
    and backward, sums in the operands' type."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).T, round_tf32(a).T @ g


def _mm(a, b, prec: Precision):
    if prec.matmul == "tf32":
        return _TF32MM.apply(a, b)
    if prec.matmul != "float32":
        raise ValueError(f"unknown matmul precision {prec.matmul!r}")
    return a @ b


class _Attention(torch.autograd.Function):
    """out (N, H·C) of xw (N, H·C) and the scores (N, H) over the
    ``Entries``, the weighted sums' operands in ``fmt``."""

    @staticmethod
    def forward(ctx, xw, s_src, s_dst, ent, slope, fmt):
        dst, src = ent.dst, ent.src
        z = s_dst[dst] + s_src[src]
        e = F.leaky_relu(z, slope)
        p = torch.exp(e - _row_sum(ent.a, e, amax=True)[dst])
        alpha = p / _row_sum(ent.a, p)[dst]
        out = _weighted_sum(ent.a, _round(alpha, fmt), _round(xw, fmt))
        ctx.save_for_backward(xw, s_src, s_dst, alpha)
        ctx.ent, ctx.slope, ctx.fmt = ent, slope, fmt
        return out

    @staticmethod
    def backward(ctx, g):
        xw, s_src, s_dst, alpha = ctx.saved_tensors
        ent, fmt = ctx.ent, ctx.fmt
        dst, src = ent.dst, ent.src
        n, k = xw.shape
        h = s_src.shape[1]
        g_r = _round(g.contiguous(), fmt)
        x_r = _round(xw, fmt).view(n, h, k // h)
        dxw = _weighted_sum(ent.at, _round(alpha, fmt)[ent.to_t], g_r)
        gh = g_r.view(n, h, k // h)
        dalpha = alpha.new_empty(alpha.shape)
        for sl in _blocks(dst.shape[0], 2 * k):
            dalpha[sl] = (gh[dst[sl]] * x_r[src[sl]]).sum(-1)
        de = alpha * (dalpha - _row_sum(ent.a, alpha * dalpha)[dst])
        z = s_dst[dst] + s_src[src]
        dz = torch.where(z > 0, de, de * ctx.slope)
        ds_src = _row_sum(ent.at, dz[ent.to_t])
        ds_dst = _row_sum(ent.a, dz)
        return dxw, ds_src, ds_dst, None, None, None


def _layer(p: dict, name: str, x, ent: Entries, heads: int, concat: bool,
           slope: float, prec: Precision, fault: str | None):
    xw = _mm(x, p[f"{name}.lin.kernel"], prec)
    n, k = xw.shape
    xh = xw.view(n, heads, k // heads)
    s_src = (xh * p[f"{name}.att_src"]).sum(-1)
    s_dst = (xh * p[f"{name}.att_dst"]).sum(-1)
    out = _Attention.apply(xw, s_src, s_dst, ent, slope, prec.aggregation)
    if fault == "lane":
        out = lane_fault(out)
    if not concat:
        out = out.view(n, heads, k // heads).mean(1)
    return out + p[f"{name}.bias"]


def _nll(logits, y, train):
    lp = F.log_softmax(logits, dim=-1)
    m = train.to(lp.dtype)
    return -(lp.gather(1, y[:, None])[:, 0] * m).sum() / m.sum().clamp(
        min=1.0)


class Model:
    def __init__(self, edge_index: torch.Tensor, n: int, x: torch.Tensor,
                 y: torch.Tensor, cfg: dict):
        self.ent = Entries(edge_index, n)
        self.x, self.y = x, y
        self.heads, self.slope = cfg["heads"], cfg["negative_slope"]

    def loss_and_grads(self, p: dict, keep_mask: torch.Tensor, keep: float,
                       train: torch.Tensor, prec: Precision = FP32,
                       fault: str | None = None):
        """No dropout: ``keep_mask`` and ``keep`` are not read."""
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        h1, h2, h3 = self.heads
        args = (self.ent,)
        with torch.enable_grad():
            a = F.elu(_layer(leaves, "conv1", self.x, *args, h1, True,
                             self.slope, prec, fault))
            a = F.elu(_layer(leaves, "conv2", a, *args, h2, True,
                             self.slope, prec, fault) + a)
            logits = _layer(leaves, "conv3", a, *args, h3, False, self.slope,
                            prec, fault)
            loss = _nll(logits, self.y, train)
            names = list(leaves)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return loss.detach(), dict(zip(names, grads))


def dense_loss(cfg, p, x, y, edge_index, n, keep_mask, keep, train):
    """The same model by torch's autograd over a dense adjacency that holds
    each entry's multiplicity, the softmax weighting every entry."""
    dst, src = entries(edge_index, n)
    mult = torch.zeros(n, n, dtype=x.dtype)
    mult.index_put_((dst, src), torch.ones(dst.shape[0], dtype=x.dtype),
                    accumulate=True)
    slope = cfg["negative_slope"]

    def layer(name, t, heads, concat):
        xw = t @ p[f"{name}.lin.kernel"]
        xh = xw.view(n, heads, -1)
        s_src = (xh * p[f"{name}.att_src"]).sum(-1)
        s_dst = (xh * p[f"{name}.att_dst"]).sum(-1)
        e = F.leaky_relu(s_dst.T[:, :, None] + s_src.T[:, None, :], slope)
        w = mult * torch.exp(e - e.amax(-1, keepdim=True))
        alpha = w / w.sum(-1, keepdim=True)             # (H, n, n)
        out = torch.einsum("hij,jhc->ihc", alpha, xh)
        out = out.reshape(n, -1) if concat else out.mean(1)
        return out + p[f"{name}.bias"]

    h1, h2, h3 = cfg["heads"]
    a = F.elu(layer("conv1", x, h1, True))
    a = F.elu(layer("conv2", a, h2, True) + a)
    return _nll(layer("conv3", a, h3, False), y, train)
