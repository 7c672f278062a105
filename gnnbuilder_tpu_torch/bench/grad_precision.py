"""How far the train step's float32 gradients sit from float64, by path.

    python -m gnnbuilder_tpu_torch.bench.grad_precision [--graphs 128 1024]
        [--hidden 128] [--output 64] [--device cuda]

On the card (or with ``--device cpu`` on the CPU, where "auto" runs the
kernels' plain versions), for the canonical PNA model (``torch.manual_seed(0)`` init;
``--hidden`` and ``--output`` set its widths) on one standard-packed QM9
batch per ``--graphs`` entry, one masked-MSE backward through four
paths: the kernels (``"auto"``), the float32 plain path (``"never"``),
the kernels' plain versions on the CPU in float32 (``"cpu32"``: the same
arithmetic as the kernels, std over v, other rounding) and the plain
path in float64.  Prints, per parameter, the worst |error| / max |value|
of auto, never and cpu32 against float64 and of auto against never;
then, per layer, the (row, column) pairs whose max or min goes another
way in the float32 layer kernel than in the float64 plain layer, each on
its own hidden state (another slot holds the extremum, or a tie holds in
one precision only), with the rows and graphs they fall in.  Such a
decision sends that max or min gradient to other neighbours.
"""

from __future__ import annotations

import argparse

import torch

from gnnbuilder_tpu_torch import train
from gnnbuilder_tpu_torch.bench.canonical import (
    canonical_batches,
    canonical_model,
)
from gnnbuilder_tpu_torch.ops import dispatch
from gnnbuilder_tpu_torch.ops.cuda import pna_layer


def _grads(model, b, target, mode):
    dispatch.set_fused_mode(mode)
    try:
        model.zero_grad()
        loss = train.masked_mse_loss(model(b), target, b.graph_mask)
        loss.backward()
    finally:
        dispatch.set_fused_mode("auto")
    return float(loss.detach()), {k: p.grad.detach().double()
                                  for k, p in model.named_parameters()}


def _scaled(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _extremal_slots(v, nbr, deg, f):
    """Slot index of the first max and first min of each (row, column)
    over the valid slots, for the first f columns of v."""
    g = v[nbr.long()][..., :f]
    valid = (torch.arange(nbr.shape[1], device=nbr.device)[None, :]
             < deg[:, None])[..., None]
    big = torch.finfo(v.dtype).max
    return (torch.where(valid, g, -big).argmax(1),
            torch.where(valid, g, big).argmin(1))


@torch.no_grad()
def decision_flips(model, b):
    """Per layer: (row, column) pairs whose max or min decision differs
    between the float32 layer kernel and the float64 plain layer, each on
    its own hidden state."""
    L = model.gnn_num_layers
    h = {torch.float32: b.node_feat, torch.float64: b.node_feat.double()}
    out = []
    for i, c in enumerate(model.gnn_convs):
        ties, slots = {}, {}
        for dt in h:
            skip = h[dt] if model.gnn_skip_connection and 0 < i < L - 1 \
                else None
            ws = [t.to(dt) for t in (c.pre_nn.weight.t(), c.pre_nn.bias,
                                     c.post_nn.weight.t(), c.post_nn.bias,
                                     c.lin.weight.t(), c.lin.bias)]
            ops = pna_layer.pad_operands(h[dt], *ws, skip)
            ops = [None if t is None else t.contiguous() for t in ops]
            fn = (pna_layer.fused_pna_layer if dt == torch.float32
                  else pna_layer.pna_layer_plain)
            o, v, _, aux, _ = fn(ops[0], b.nbr_nodes, b.in_degree,
                                 *ops[1:7], c.delta, skip=ops[7],
                                 act=model.gnn_activation, save_res=True)
            F, f = ops[1].shape[1], ws[0].shape[1]
            ties[dt] = torch.cat([aux[:, 3 * F:3 * F + f],
                                  aux[:, 4 * F:4 * F + f]], 1).float()
            slots[dt] = torch.cat(_extremal_slots(v, b.nbr_nodes,
                                                  b.in_degree, f), 1)
            h[dt] = o[:, :c.out_channels].contiguous()
        flip = ((ties[torch.float32] != ties[torch.float64])
                | (slots[torch.float32] != slots[torch.float64]))
        rows = torch.nonzero(flip.any(1)).flatten()
        graphs = torch.searchsorted(b.graph_starts.long(), rows,
                                    right=True) - 1
        out.append(dict(layer=i, flips=int(flip.sum()), rows=rows.tolist(),
                        graphs=graphs.tolist()))
    return out


def run(n_graphs, device, **widths):
    # a 1024-graph batch is drawn from 1100 graphs, as chip_smoke.py's
    # train batch (and the JAX package's train benchmark) draws it
    gs, (b,) = canonical_batches("qm9", n_graphs=1100 if n_graphs == 1024
                                 else n_graphs, batch_size=n_graphs,
                                 node_multiple=256, device=device)
    target = train.stack_targets(gs[:n_graphs], b.num_graphs, device=device)
    torch.manual_seed(0)
    model = canonical_model("pna", "qm9", graphs=gs, **widths).to(device)
    state = model.state_dict()
    ref = canonical_model("pna", "qm9", graphs=gs, **widths).to(device)
    ref.double().load_state_dict({k: v.double() for k, v in state.items()})
    cpu = canonical_model("pna", "qm9", graphs=gs, **widths)
    cpu.load_state_dict({k: v.cpu() for k, v in state.items()})
    losses, g = {}, {}
    for mode in ("auto", "never"):
        losses[mode], g[mode] = _grads(model, b, target, mode)
    losses["f64"], g["f64"] = _grads(
        ref, b.replace(node_feat=b.node_feat.double()), target.double(),
        "never")
    losses["cpu32"], g["cpu32"] = _grads(cpu, b.to("cpu"), target.cpu(),
                                         "auto")
    print(f"== {n_graphs} graphs, {widths or 'canonical widths'}: "
          f"N={b.num_nodes} losses {losses}")
    print(f"{'parameter':40s} auto-f64  never-f64 cpu32-f64 auto-never")
    for k in g["f64"]:
        print(f"{k:40s} {_scaled(g['auto'][k], g['f64'][k]):.2e}  "
              f"{_scaled(g['never'][k], g['f64'][k]):.2e}  "
              f"{_scaled(g['cpu32'][k].to(device), g['f64'][k]):.2e}  "
              f"{_scaled(g['auto'][k], g['never'][k]):.2e}")
    for d in decision_flips(model, b):
        print(f"layer {d['layer']}: {d['flips']} max/min decisions differ, "
              f"rows {d['rows']}, graphs {sorted(set(d['graphs']))}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graphs", type=int, nargs="+", default=[128, 1024])
    ap.add_argument("--hidden", type=int, default=None)
    ap.add_argument("--output", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card; pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    widths = {k: v for k, v in (("gnn_hidden_dim", args.hidden),
                                ("gnn_output_dim", args.output))
              if v is not None}
    for n in args.graphs:
        run(n, device, **widths)


if __name__ == "__main__":
    main()
