"""The paper's own experimental models (§6), PyTorch port of the JAX
package's ``models/paper_nets.py``.

  2NN        — MLP, 2 hidden layers x 200 ReLU units (199,210 params on
               784->10 MNIST-shaped data)                      [Fig 4-6]
  CNN        — 2x conv5x5 (32, 64) + 2x2 maxpool + fc512 + softmax
               (1,663,370 params at 28x28x1)                   [Fig 2-3]
  CharLSTM   — 8-dim char embedding -> 2x LSTM(256) -> softmax
               (820,522 params at vocab 90)                    [Fig 7]
  MiniResNet — small ResNet for the CIFAR-like bench           [Fig 8]

Parameters are plain flat dicts in the JAX package's layout: dense
weights ``[d_in, d_out]`` applied as ``x @ w``, convolutions HWIO over
NHWC inputs, a nested cell's leaves named ``"l1/wx"`` (``convert``'s
flat names). Every apply takes a leading client axis on the params and
the inputs (one model each), or none. The convolutions fold the m
clients into the channels: input ``[B, m*C, H, W]``, weight ``[m*O, C,
kh, kw]``, ``groups=m`` — one launch a layer for all clients; the
NHWC/HWIO transposes happen inside ``apply``. The LSTM's ``lax.scan`` is
a Python loop over time.

:func:`make_2nn_loss` is the 2NN's cross-entropy with a column-parallel
form (:func:`apply_2nn_columns`), which a round on a 2D ``(clients,
model)`` mesh trains tensor-parallel under any cut of the 2NN's leaves.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import prng
from ..device import resolve_device
from ..sharding.tensor_parallel import with_column_parallel
from .layers import dense_init

Params = dict[str, torch.Tensor]
Key = torch.Tensor | int


def _keys(key: Key, n: int) -> list[torch.Tensor]:
    """``split(key, n)`` on the CPU, as the reference's inits split their
    key; an int seed means ``prng.PRNGKey(seed)``."""
    if isinstance(key, int):
        key = prng.PRNGKey(key)
    return list(prng.split(key.to("cpu"), n))


def _placed(params: Params, device) -> Params:
    dev = resolve_device(device)
    return {n: t.to(dev) for n, t in params.items()}


def _per_client(apply, params: Params, x: torch.Tensor, probe: str,
                rank: int, **kw) -> torch.Tensor:
    """Run ``apply`` (written for a leading client axis) on params whose
    ``probe`` leaf has ``rank`` dims without it, by adding an axis of 1."""
    if params[probe].dim() == rank + 1:
        return apply(params, x, **kw)
    one = {n: t.unsqueeze(0) for n, t in params.items()}
    return apply(one, x.unsqueeze(0), **kw)[0]


def init_2nn(key: Key, *, d_in: int = 784, d_hidden: int = 200,
             n_classes: int = 10, dtype=torch.float32, device=None
             ) -> Params:
    """2NN parameters drawn from ``key`` (a port PRNG key, or a seed) on
    the CPU as the reference's ``init_2nn`` draws them (``split(key,
    3)``, one key a weight), then placed on ``device`` (CUDA unless
    ``"cpu"`` is given)."""
    k1, k2, k3 = _keys(key, 3)
    params = {
        "w1": dense_init(k1, (d_in, d_hidden), dtype),
        "b1": torch.zeros((d_hidden,), dtype=dtype),
        "w2": dense_init(k2, (d_hidden, d_hidden), dtype),
        "b2": torch.zeros((d_hidden,), dtype=dtype),
        "w3": dense_init(k3, (d_hidden, n_classes), dtype),
        "b3": torch.zeros((n_classes,), dtype=dtype),
    }
    return _placed(params, device)


def apply_2nn(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x [..., B, d_in] -> logits [..., B, n_classes]; a leading client
    axis on params (w [m, d_in, d_out], b [m, d_out]) batches clients."""
    h = F.relu(x @ params["w1"] + params["b1"].unsqueeze(-2))
    h = F.relu(h @ params["w2"] + params["b2"].unsqueeze(-2))
    return h @ params["w3"] + params["b3"].unsqueeze(-2)


def _dense_columns(group, h, w, b, dim):
    """``h @ w + b`` of one 2NN layer over ``group``'s columns, ``dim``
    the stacked weight's cut dim (None: replicated): a column-cut w
    (dim 2) gives each column its output slice (a list; a whole bias
    narrowed to it), a row-cut w (dim 1) sums the columns' partials at
    home, a replicated w runs at home. ``h`` is a home tensor or the
    columns' slices of its features; a cut bias that meets a home sum
    is gathered (a row-cut w reads h's slices, and gathers nothing)."""
    full = group.gather(h, -1) if isinstance(h, list) and dim != 1 else h
    if dim == 2:
        out = []
        bs = b if isinstance(b, list) else group.broadcast(b)
        for c, hc in enumerate(group.broadcast(full)):
            bc = bs[c] if isinstance(b, list) else bs[c].narrow(
                -1, c * w[c].shape[-1], w[c].shape[-1])
            out.append(hc @ w[c] + bc.unsqueeze(-2))
        return out
    bias = group.gather(b, -1) if isinstance(b, list) else b
    if dim == 1:
        parts = h if isinstance(h, list) else group.slice(h, -1)
        y = group.reduce_sum([hc @ wc for hc, wc in zip(parts, w)])
    else:
        y = full @ w
    return y + bias.unsqueeze(-2)


def apply_2nn_columns(group, params: dict, x: torch.Tensor) -> torch.Tensor:
    """:func:`apply_2nn` on a 2D mesh row's view (``ColumnGroup.view``;
    ``group.dims`` says how each leaf is cut): x [m, B, d_in] and the
    logits at home. Under the hand specs (w1's columns, w2's and w3's
    rows, the biases cut) w1 is column-parallel with b1 and the ReLU on
    the cut, w2 row-parallel, its sum plus the gathered b2, and w3
    row-parallel over the sliced h2, plus the gathered b3."""
    h = x
    for i in (1, 2, 3):
        h = _dense_columns(group, h, params[f"w{i}"], params[f"b{i}"],
                           group.dims.get(f"w{i}"))
        if i < 3:
            h = [F.relu(p) for p in h] if isinstance(h, list) else F.relu(h)
    return group.gather(h, -1) if isinstance(h, list) else h


_2NN_LEAVES = ("b1", "b2", "b3", "w1", "w2", "w3")


def make_2nn_loss():
    """The 2NN's mean cross-entropy ``(params, {"x", "y"}, rng) -> [m]``
    carrying its column-parallel form (:func:`apply_2nn_columns`)."""
    return with_column_parallel(
        lambda p, b, r: softmax_xent(apply_2nn(p, b["x"]), b["y"]),
        lambda g, view, b, r: softmax_xent(apply_2nn_columns(g, view,
                                                             b["x"]),
                                           b["y"]),
        lambda name, dims: name in _2NN_LEAVES)


# ---------------------------------------------------------------------------
# Convolutions with the clients folded into the channels
# ---------------------------------------------------------------------------

def _grouped(x: torch.Tensor) -> torch.Tensor:
    """NHWC inputs of m clients [m, B, H, W, C] -> [B, m*C, H, W]."""
    m, b, h, w, c = x.shape
    return x.permute(1, 0, 4, 2, 3).reshape(b, m * c, h, w)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """JAX "SAME" padding of one side: ``total = max((out - 1) * s + k -
    in, 0)`` with ``out = ceil(in / s)``, ``total // 2`` before and the
    rest after (at stride 2 on an even side: 0 before, 1 after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(h: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """JAX ``conv_general_dilated(..., padding="SAME")`` of every client at
    once: h [B, m*C, H, W], w per client HWIO [m, kh, kw, C, O] ->
    [B, m*O, H', W'] (one grouped convolution, ``groups=m``)."""
    m, kh, kw, c, o = w.shape
    wg = w.permute(0, 4, 3, 1, 2).reshape(m * o, c, kh, kw)
    top, bottom = _same_pads(h.shape[2], kh, stride)
    left, right = _same_pads(h.shape[3], kw, stride)
    if top == bottom and left == right:
        return F.conv2d(h, wg, stride=stride, padding=(top, left), groups=m)
    return F.conv2d(F.pad(h, (left, right, top, bottom)), wg, stride=stride,
                    groups=m)


def _bias(b: torch.Tensor) -> torch.Tensor:
    """Per-client channel bias [m, O] as [1, m*O, 1, 1]."""
    return b.reshape(1, -1, 1, 1)


def _ungrouped(h: torch.Tensor, m: int) -> torch.Tensor:
    """[B, m*C, H, W] -> each client's NHWC rows flattened [m, B, H*W*C]
    (the JAX package's ``h.reshape(b, -1)`` of NHWC)."""
    b, mc, hh, ww = h.shape
    return (h.reshape(b, m, mc // m, hh, ww).permute(1, 0, 3, 4, 2)
            .reshape(m, b, -1))


# ---------------------------------------------------------------------------
# CNN (paper's MNIST CNN)
# ---------------------------------------------------------------------------

def init_cnn(key: Key, *, in_ch: int = 1, n_classes: int = 10,
             img: int = 28, dtype=torch.float32, device=None) -> Params:
    """CNN parameters (HWIO convolutions) drawn from ``key`` (or a seed)
    on the CPU in the reference's order (``split(key, 4)``), then placed
    on ``device`` (CUDA unless ``"cpu"``)."""
    k1, k2, k3, k4 = _keys(key, 4)
    side = img // 4            # two 2x2 maxpools
    return _placed({
        "c1": dense_init(k1, (5, 5, in_ch, 32), dtype, fan_in=25 * in_ch),
        "cb1": torch.zeros((32,), dtype=dtype),
        "c2": dense_init(k2, (5, 5, 32, 64), dtype, fan_in=25 * 32),
        "cb2": torch.zeros((64,), dtype=dtype),
        "w1": dense_init(k3, (side * side * 64, 512), dtype),
        "b1": torch.zeros((512,), dtype=dtype),
        "w2": dense_init(k4, (512, n_classes), dtype),
        "b2": torch.zeros((n_classes,), dtype=dtype),
    }, device)


def _apply_cnn(params: Params, x: torch.Tensor) -> torch.Tensor:
    m = params["c1"].shape[0]
    h = F.relu(_conv(_grouped(x), params["c1"]) + _bias(params["cb1"]))
    h = F.max_pool2d(h, 2)
    h = F.relu(_conv(h, params["c2"]) + _bias(params["cb2"]))
    h = _ungrouped(F.max_pool2d(h, 2), m)
    h = F.relu(h @ params["w1"] + params["b1"].unsqueeze(-2))
    return h @ params["w2"] + params["b2"].unsqueeze(-2)


def apply_cnn(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x [m, B, H, W, C] -> logits [m, B, n_classes] (or without the
    client axis on both)."""
    return _per_client(_apply_cnn, params, x, "c1", 4)


# ---------------------------------------------------------------------------
# Char-LSTM (paper's Shakespeare model)
# ---------------------------------------------------------------------------

def init_lstm_cell(key: Key, d_in: int, d_h: int, dtype=torch.float32,
                   prefix: str = "") -> Params:
    """One cell's leaves ``wx``, ``wh``, ``b`` (gates i, f, g, o), named
    ``prefix + leaf``, from ``split(key, 2)``."""
    k1, k2 = _keys(key, 2)
    return {prefix + "wx": dense_init(k1, (d_in, 4 * d_h), dtype),
            prefix + "wh": dense_init(k2, (d_h, 4 * d_h), dtype,
                                      fan_in=d_h),
            prefix + "b": torch.zeros((4 * d_h,), dtype=dtype)}


def lstm_cell(params: Params, carry, xw: torch.Tensor, prefix: str = ""):
    """One step from the input's product ``xw = x @ wx`` (a layer computes
    it for every step at once): ``gates = xw + h @ wh + b`` split i, f, g,
    o; ``c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g)``, ``h' =
    sigmoid(o) * tanh(c')``. Returns ``((h', c'), h')``; params carry the
    client axis or not, as h does."""
    h, c = carry
    gates = xw + h @ params[prefix + "wh"] + params[prefix + "b"].unsqueeze(-2)
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def init_charlstm(key: Key, *, vocab: int = 90, d_embed: int = 8,
                  d_h: int = 256, dtype=torch.float32, device=None
                  ) -> Params:
    """CharLSTM parameters from ``split(key, 4)`` (embedding, the two
    cells, the head), the cells' leaves named ``l1/...``, ``l2/...`` (the
    flat names of the JAX package's nested tree)."""
    k1, k2, k3, k4 = _keys(key, 4)
    return _placed({
        "embed": dense_init(k1, (vocab, d_embed), dtype, fan_in=d_embed),
        **init_lstm_cell(k2, d_embed, d_h, dtype, "l1/"),
        **init_lstm_cell(k3, d_h, d_h, dtype, "l2/"),
        "out": dense_init(k4, (d_h, vocab), dtype),
        "out_b": torch.zeros((vocab,), dtype=dtype),
    }, device)


def _lstm_layer(params: Params, prefix: str, seq: torch.Tensor
                ) -> torch.Tensor:
    """One layer over time: seq [m, B, L, d_in] -> hidden states
    [m, B, L, d_h], the input products ``x @ wx`` of all steps in one
    matmul."""
    m, b, length, d_in = seq.shape
    d_h = params[prefix + "wh"].shape[-2]
    xw = (seq.reshape(m, b * length, d_in) @ params[prefix + "wx"]
          ).reshape(m, b, length, 4 * d_h)
    zero = seq.new_zeros((m, b, d_h))
    carry, hs = (zero, zero), []
    for t in range(length):
        carry, h = lstm_cell(params, carry, xw[:, :, t], prefix)
        hs.append(h)
    return torch.stack(hs, dim=2)


def _apply_charlstm(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]                                   # [m, V, e]
    m, vocab, e = emb.shape
    offset = torch.arange(m, device=tokens.device).reshape(
        (m,) + (1,) * (tokens.dim() - 1)) * vocab
    # Client c's row t is row c*V + t of the stacked table: one gather
    # (and a deterministic backward on the card) for all clients.
    x = F.embedding(tokens.long() + offset, emb.reshape(m * vocab, e))
    h = _lstm_layer(params, "l1/", x)
    h = _lstm_layer(params, "l2/", h)
    b, length = tokens.shape[1:]
    logits = h.reshape(m, b * length, -1) @ params["out"]
    return (logits + params["out_b"].unsqueeze(-2)).reshape(m, b, length, -1)


def apply_charlstm(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [m, B, L] -> logits [m, B, L, vocab] (or without the client
    axis on both)."""
    return _per_client(_apply_charlstm, params, tokens, "embed", 2)


# ---------------------------------------------------------------------------
# Mini ResNet (CIFAR-like bench; ResNet20-family, narrower)
# ---------------------------------------------------------------------------

def init_miniresnet(key: Key, *, in_ch: int = 3, width: int = 8,
                    n_classes: int = 10, blocks: int = 2,
                    dtype=torch.float32, device=None) -> Params:
    """MiniResNet parameters (HWIO convolutions; a 1x1 shortcut where a
    block changes stride or width), drawn in the JAX package's order:
    ``split(key, 4 + 4 * blocks * 3)``, taken one a weight."""
    ks = iter(_keys(key, 4 + 4 * blocks * 3))
    p = {"stem": dense_init(next(ks), (3, 3, in_ch, width), dtype,
                            fan_in=9 * in_ch),
         "stem_b": torch.zeros((width,), dtype=dtype)}
    ch = width
    for s, stride in enumerate((1, 2, 2)):
        out_ch = width * (2 ** s)
        for bl in range(blocks):
            pref = f"s{s}b{bl}"
            st = stride if bl == 0 else 1
            p[pref + "_c1"] = dense_init(next(ks), (3, 3, ch, out_ch),
                                         dtype, fan_in=9 * ch)
            p[pref + "_b1"] = torch.zeros((out_ch,), dtype=dtype)
            p[pref + "_c2"] = dense_init(next(ks), (3, 3, out_ch, out_ch),
                                         dtype, fan_in=9 * out_ch)
            p[pref + "_b2"] = torch.zeros((out_ch,), dtype=dtype)
            if st != 1 or ch != out_ch:
                p[pref + "_sc"] = dense_init(next(ks), (1, 1, ch, out_ch),
                                             dtype, fan_in=ch)
            ch = out_ch
    p["head"] = dense_init(next(ks), (ch, n_classes), dtype)
    p["head_b"] = torch.zeros((n_classes,), dtype=dtype)
    return _placed(p, device)


def _apply_miniresnet(params: Params, x: torch.Tensor, *, width: int,
                      blocks: int) -> torch.Tensor:
    del width                    # the shapes come from the parameters
    m = params["stem"].shape[0]
    h = F.relu(_conv(_grouped(x), params["stem"]) + _bias(params["stem_b"]))
    for s, stride in enumerate((1, 2, 2)):
        for bl in range(blocks):
            pref = f"s{s}b{bl}"
            st = stride if bl == 0 else 1
            y = F.relu(_conv(h, params[pref + "_c1"], st)
                       + _bias(params[pref + "_b1"]))
            y = _conv(y, params[pref + "_c2"]) + _bias(params[pref + "_b2"])
            sc = (_conv(h, params[pref + "_sc"], st)
                  if pref + "_sc" in params else h)
            h = F.relu(y + sc)
    b, mc = h.shape[:2]
    h = h.mean(dim=(2, 3)).reshape(b, m, mc // m).transpose(0, 1)
    return h @ params["head"] + params["head_b"].unsqueeze(-2)


def apply_miniresnet(params: Params, x: torch.Tensor, *, width: int = 8,
                     blocks: int = 2) -> torch.Tensor:
    """x [m, B, H, W, C] -> logits [m, B, n_classes] (or without the
    client axis on both)."""
    return _per_client(_apply_miniresnet, params, x, "stem", 4, width=width,
                       blocks=blocks)


# ---------------------------------------------------------------------------
# Shared loss helpers
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch axis: logits [..., B, C], labels
    [..., B] -> [...] (a scalar without leading axes, as in JAX)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return nll.mean(dim=-1)


def count_params(params: Params) -> int:
    """The number of values in a parameter dict."""
    return sum(int(p.numel()) for p in params.values())
