"""Golden-data serialization in the reference's testbench binary format
(the JAX package's ``verify/golden.py``).

The reference dumps every model parameter and per-graph tensors as raw
little-endian binaries consumed by its C++ testbench
(``gen_testbench_data`` code_gen.py:227-305, ``serialize_tensor``
utils.py:113-115, name combiner utils.py:99-100), indexed by a
``dataset_info.txt``.  This module writes that layout from a ``Program``
of this package, with the file names and bytes the JAX package writes
for the same weights: the parameters go through ``port.params_to_jax``
to the flax tree's names and [in, out] kernels before they are
flattened.  ``parity_check`` replays the graphs through the Program (on
its device: the card by default) and reports the testbench's MAE
(model_tb.cpp.jinja:242-258, parsed back at code_gen.py:384-395).

Layout under ``out_dir``::

    model_parameters/<layer>_<param>.bin        float32 raw
    graphs/graph_<i>_info.bin                   int32 [num_nodes, num_edges]
    graphs/graph_<i>_coo.bin                    int32 [E, 2] = edge_index.T
    graphs/graph_<i>_node_features.bin          float32 [n, F]
    graphs/graph_<i>_task_golden_output.bin     float32 (when labels given)
    graphs/graph_<i>_model_golden_output.bin    float32 [out_dim]
    dataset_info.txt                            "num_graphs N" + index lines
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "serialize_tensor",
    "serialize_params",
    "gen_testbench_data",
    "load_golden_outputs",
    "parity_check",
    "VALID_OUTPUT_ENCODINGS",
]

VALID_OUTPUT_ENCODINGS = (
    "regression", "classification_integer", "classification_onehot"
)


def serialize_tensor(t, path: str) -> None:
    """Raw binary dump (reference utils.py:113-115); a torch tensor is
    brought to the host first."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    np.ascontiguousarray(np.asarray(t)).tofile(path)


def _param_name_combiner(layer: str, param: str) -> str:
    # reference layer_param_name_combiner (utils.py:99-100)
    return f"{layer}_{param}"


def _flatten_params(params) -> dict:
    """{file name: float32 array} of a state dict of this package's
    ``GNNModel``: each leaf of its flax tree (``port.params_to_jax``)
    named by its path, joined with ``_``."""
    from gnnbuilder_tpu_torch.port import params_to_jax

    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + [k], v)
        else:
            name = _param_name_combiner(
                "_".join(prefix[:-1]) or "root", prefix[-1]
            )
            flat[name] = np.asarray(node, dtype=np.float32)

    walk([], params_to_jax(params)["params"])
    return flat


def serialize_params(params, out_dir: str) -> list[str]:
    """Every parameter tensor of a ``GNNModel`` state dict ->
    ``model_parameters/<layer>_<param>.bin`` (reference
    code_gen.py:239-246)."""
    pdir = os.path.join(out_dir, "model_parameters")
    os.makedirs(pdir, exist_ok=True)
    written = []
    for name, arr in sorted(_flatten_params(params).items()):
        path = os.path.join(pdir, f"{name}.bin")
        serialize_tensor(arr, path)
        written.append(path)
    return written


def _forward_one(program, g) -> np.ndarray:
    """The Program's output for graph ``g`` alone, on the host."""
    out = program.forward(program.batch([g]))
    return out[0].detach().cpu().numpy().astype(np.float32)


def gen_testbench_data(
    program,
    graphs: Sequence,
    out_dir: str,
    max_graphs: Optional[int] = None,
    output_encoding: str = "regression",
    num_classes: Optional[int] = None,
) -> dict:
    """Serialize parameters + per-graph inputs + the model's golden outputs
    (reference code_gen.py:227-305), each graph's golden output from the
    Program's forward of that graph alone.

    ``output_encoding`` mirrors the reference's pyg_output_encoding switch
    (code_gen.py:101-109, 270-277) for the task_golden_output files:
    "regression" / "classification_onehot" write y as-is (the onehot mode
    additionally checks width == num_classes); "classification_integer"
    expands an integer class label into a one-hot float vector of
    ``num_classes``."""
    if output_encoding not in VALID_OUTPUT_ENCODINGS:
        raise ValueError(
            f"output_encoding must be one of {VALID_OUTPUT_ENCODINGS}, "
            f"got {output_encoding!r}"
        )
    if output_encoding == "classification_integer" and not num_classes:
        raise ValueError("classification_integer needs num_classes")
    os.makedirs(out_dir, exist_ok=True)
    if not program._initialized:
        program.init_params()
    serialize_params(program.params, out_dir)

    gdir = os.path.join(out_dir, "graphs")
    os.makedirs(gdir, exist_ok=True)

    n = len(graphs) if max_graphs is None else min(len(graphs), max_graphs)
    # reference dataset_info.txt format: header + one dataset index per line
    # (code_gen.py:252-257)
    with open(os.path.join(out_dir, "dataset_info.txt"), "w") as f:
        f.write(f"num_graphs {n}\n")
        for i in range(n):
            f.write(f"{i}\n")

    outs = []
    for i in range(n):
        g = graphs[i]
        num_nodes = int(g.x.shape[0])
        num_edges = int(g.edge_index.shape[1])
        serialize_tensor(
            np.asarray([num_nodes, num_edges], np.int32),
            os.path.join(gdir, f"graph_{i}_info.bin"),
        )
        # reference serializes edge_index.T: [E, 2] interleaved (from, to)
        # pairs (code_gen.py:262)
        serialize_tensor(
            np.ascontiguousarray(np.asarray(g.edge_index, np.int32).T),
            os.path.join(gdir, f"graph_{i}_coo.bin"),
        )
        serialize_tensor(
            np.asarray(g.x, np.float32),
            os.path.join(gdir, f"graph_{i}_node_features.bin"),
        )
        y = getattr(g, "y", None)
        if y is not None:
            if output_encoding == "classification_integer":
                # reference code_gen.py:272-275: integer label -> one-hot
                t = np.zeros((num_classes,), np.float32)
                t[int(np.asarray(y).reshape(-1)[0])] = 1.0
            else:
                t = np.asarray(y, np.float32).reshape(-1)
                if (output_encoding == "classification_onehot"
                        and num_classes is not None
                        and t.shape[0] != num_classes):
                    # reference code_gen.py:276-277
                    raise ValueError(f"graph {i}: a one-hot label of "
                                     f"{t.shape[0]} classes, expected "
                                     f"{num_classes}")
            serialize_tensor(
                t,
                os.path.join(gdir, f"graph_{i}_task_golden_output.bin"),
            )
        out = _forward_one(program, g)
        serialize_tensor(
            out, os.path.join(gdir, f"graph_{i}_model_golden_output.bin")
        )
        outs.append(out)
    return {"num_graphs": n, "out_dim": outs[0].shape[-1] if outs else 0}


def load_golden_outputs(out_dir: str) -> list[np.ndarray]:
    with open(os.path.join(out_dir, "dataset_info.txt")) as f:
        lines = f.read().strip().splitlines()
    head = lines[0].split()
    if head[0] != "num_graphs":
        raise ValueError(f"bad dataset_info header: {lines[0]!r}")
    n = int(head[1])
    outs = []
    for line in lines[1: n + 1]:
        idx = int(line)
        outs.append(
            np.fromfile(
                os.path.join(
                    out_dir, "graphs", f"graph_{idx}_model_golden_output.bin"
                ),
                dtype=np.float32,
            )
        )
    return outs


def parity_check(program, graphs: Sequence, golden_dir: str) -> dict:
    """Replay the graphs through the Program, one at a time as
    ``gen_testbench_data`` wrote them, and report the MAE against the
    serialized goldens: the testbench's model_output_mae
    (model_tb.cpp.jinja:242-258 / code_gen.py:384-395)."""
    goldens = load_golden_outputs(golden_dir)
    errs = []
    for g, golden in zip(graphs, goldens):
        errs.append(np.abs(_forward_one(program, g) - golden).mean())
    mae = float(np.mean(errs)) if errs else 0.0
    return {"model_output_mae": mae, "num_graphs": len(errs)}
