"""Plain PyTorch pieces that the configurations' references share: the
adjacency in CSR order with its aggregations, the dropout draw, the masked
NLL, Adam, and the precisions the controls compute in.

Nothing here imports the port.  The aggregations gather each row's
neighbours into a padded block, rows grouped by their degree rounded up to
a power of two, and reduce over the block: no atomics, so a sum is the same
on every run, and a max breaks ties towards the lowest column, which is
the lowest CSR position.  Blocks hold at most ``BLOCK_ELEMS`` elements.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

BLOCK_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class Precision:
    """What a reference computes in.  ``matmul``: ``float32`` or ``tf32``
    (both operands rounded to 10 mantissa bits, sums in float32, which is
    what TF32 tensor cores compute).  ``aggregation``: the operands of a
    sum aggregation's products, ``float32`` or ``float8_e4m3`` (a
    per-tensor scale to the format's largest value)."""

    matmul: str = "float32"
    aggregation: str = "float32"


FP32 = Precision()


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32).view(t.shape)


def quantize(t: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "float32":
        return t
    if fmt == "float8_e4m3":
        amax = t.abs().amax().clamp(min=torch.finfo(torch.float32).tiny)
        s = 448.0 / amax
        return (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    raise ValueError(f"unknown aggregation precision {fmt!r}")


def mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    if prec.matmul == "tf32":
        return round_tf32(a) @ round_tf32(b)
    if prec.matmul != "float32":
        raise ValueError(f"unknown matmul precision {prec.matmul!r}")
    return a @ b


def dropout_keep(shape, keep: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """The draw of the port's dropout (``nn/models.py`` ``_dropout``), one
    ``torch.rand`` of the activation's shape, frozen here: True keeps."""
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(h: torch.Tensor, keep_mask: torch.Tensor, keep: float):
    return torch.where(keep_mask, h / keep, torch.zeros_like(h))


def masked_nll(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """Mean NLL of log-probabilities over ``mask``, and its gradient in the
    pre-softmax logits: (softmax − onehot) · mask / |mask|."""
    lp = F.log_softmax(logits, dim=-1)
    m = mask.to(lp.dtype)
    n = m.sum().clamp(min=1.0)
    loss = -(lp.gather(1, y[:, None])[:, 0] * m).sum() / n
    g = lp.exp()
    g[torch.arange(g.shape[0], device=g.device), y] -= 1.0
    return loss, g * (m / n)[:, None]


def half_mask(mask: torch.Tensor) -> torch.Tensor:
    """Every other node of ``mask`` in id order: a batch with half its rows
    left out (a fault the checks must catch)."""
    return mask & (torch.cumsum(mask.to(torch.int64), 0) % 2 == 1)


class Adam:
    """``torch.optim.Adam`` with coupled L2 (``weight_decay``), written out."""

    def __init__(self, params: dict, lr: float, betas, eps: float,
                 weight_decay: float):
        self.lr, (self.b1, self.b2) = lr, betas
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> tuple[dict, dict]:
        """New parameters, and the gradients as the update used them
        (with the decay term)."""
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        new, used = {}, {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            denom = self.v[k].sqrt() / bc2 ** 0.5 + self.eps
            new[k] = p - (self.lr / bc1) * self.m[k] / denom
            used[k] = g
        return new, used


class Adjacency:
    """Entries (row, col, value) of a graph in CSR order: sorted by row,
    then column, stably.  ``value`` None means every entry is 1."""

    def __init__(self, row: torch.Tensor, col: torch.Tensor,
                 value: torch.Tensor | None, num_rows: int, num_cols: int):
        order = torch.sort(row * num_cols + col, stable=True).indices
        row = row[order]
        self.num_rows, self.num_cols = num_rows, num_cols
        self.nnz = int(row.numel())
        self.col = torch.cat([col[order], col.new_full((1,), num_cols)])
        self.value = (None if value is None else
                      torch.cat([value[order], value.new_zeros(1)]))
        self.deg = torch.bincount(row, minlength=num_rows)
        self.rowptr = torch.cumsum(self.deg, 0) - self.deg
        # rows by padded width 2^b, b = ceil(log2(deg))
        d = self.deg.clamp(min=1)
        b = torch.ceil(torch.log2(d.double())).long()
        b = b + ((1 << b) < d).long()
        b = b - ((b > 0) & ((1 << (b - 1).clamp(min=0)) >= d)).long()
        width = torch.where(self.deg > 0, 1 << b, torch.zeros_like(b))
        self.buckets = [(torch.nonzero(width == w)[:, 0], int(w))
                        for w in torch.unique(width).tolist() if w > 0]

    def _blocks(self, k: int):
        """(rows, positions (r, w) with the pad position ``nnz`` past each
        row's end, feature range) blocks of at most ``BLOCK_ELEMS``."""
        for rows, w in self.buckets:
            kc = k if w * k <= BLOCK_ELEMS else max(1, BLOCK_ELEMS // w)
            rc = max(1, BLOCK_ELEMS // (w * kc))
            ar = torch.arange(w, device=rows.device)
            for r0 in range(0, rows.numel(), rc):
                rr = rows[r0:r0 + rc]
                pos = self.rowptr[rr, None] + ar
                pos = torch.where(ar < self.deg[rr, None], pos, self.nnz)
                for f0 in range(0, k, kc):
                    yield rr, pos, f0, min(k, f0 + kc)

    def sum(self, x: torch.Tensor, fmt: str = "float32") -> torch.Tensor:
        """out[r] = Σ value[e] · x[col e] over the row's entries, with both
        operands in ``fmt`` and the sums in float32."""
        x = quantize(x, fmt)
        val = None if self.value is None else quantize(self.value, fmt)
        xp = torch.cat([x, x.new_zeros(1, x.shape[1])])
        out = x.new_zeros(self.num_rows, x.shape[1])
        for rr, pos, f0, f1 in self._blocks(x.shape[1]):
            m = xp[:, f0:f1][self.col[pos]]
            if val is not None:
                m = m * val[pos][..., None]
            out[rr, f0:f1] = m.sum(1)
        return out

    def max(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """out[r] = max over the row's entries of value[e] · x[col e] (0 for
        a row without entries) and the winning column, the lowest among
        ties (-1 for a row without entries)."""
        if self.value is not None:
            raise ValueError("the max reference takes unit values only")
        k = x.shape[1]
        xp = torch.cat([x, x.new_full((1, k), float("-inf"))])
        out = x.new_zeros(self.num_rows, k)
        arg = torch.full((self.num_rows, k), -1, dtype=torch.int64,
                         device=x.device)
        for rr, pos, f0, f1 in self._blocks(k):
            cols = self.col[pos]
            v, i = xp[:, f0:f1][cols].max(1)
            out[rr, f0:f1] = v
            arg[rr, f0:f1] = cols.gather(1, i)
        return out, arg


def route_max(g: torch.Tensor, arg: torch.Tensor, num_cols: int):
    """The gradient of a max aggregation in its input: each (row, feature)
    cotangent added to the winning column's feature."""
    k = g.shape[1]
    flat = arg * k + torch.arange(k, device=g.device)
    keep = arg >= 0
    out = g.new_zeros(num_cols * k)
    out.index_add_(0, flat[keep], g[keep])
    return out.view(num_cols, k)


def lane_fault(t: torch.Tensor) -> torch.Tensor:
    """An aggregation's output with one feature left unwritten (zero), as a
    kernel lane that never stores would leave it (a fault the checks must
    catch)."""
    t = t.clone()
    t[:, 0] = 0.0
    return t


def follow(model, params0: dict, cfg: dict, train: torch.Tensor,
           steps: int, dropout_seed: int, prec: Precision = FP32,
           fault: str | None = None) -> dict:
    """``steps`` training steps of a configuration's reference ``model``
    from ``params0``: the dropout draws of a generator seeded with
    ``dropout_seed``, the masked NLL over ``train``, Adam.  Returns the
    loss of each step, the first step's gradients as Adam used them and
    the parameters after the last step.  ``fault``: ``"unchanged"`` leaves
    the state as it was (no update, no optimizer state), ``"half_batch"``
    takes the loss over every other training node, ``"lane"`` zeroes one
    feature of every aggregation (the model reads it)."""
    device = train.device
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    opt = cfg["optimizer"]
    adam = Adam(params0, opt["lr"], opt["betas"], opt["eps"],
                opt["weight_decay"])
    mask = half_mask(train) if fault == "half_batch" else train
    keep = 1.0 - cfg["dropout"]
    params, losses, first = dict(params0), [], None
    for _ in range(steps):
        keep_mask = dropout_keep((train.shape[0], cfg["hidden"]), keep, gen,
                                 device)
        loss, grads = model.loss_and_grads(params, keep_mask, keep, mask,
                                           prec, fault)
        if fault == "unchanged":
            used = {k: torch.zeros_like(v) for k, v in params.items()}
        else:
            params, used = adam.step(params, grads)
        losses.append(float(loss))
        first = used if first is None else first
    return dict(losses=losses, first_grad=first, params=params)
