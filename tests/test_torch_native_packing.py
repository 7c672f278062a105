"""The port's native packer (``gnnbuilder_tpu_torch/native``) against its
numpy plain version and against the JAX package's packing, bit for bit,
over the parameters of the JAX package's ``tests/test_native_packing.py``;
a failed build raises; two processes building at once both load."""

import os
import subprocess
import sys

import numpy as np
import pytest

from gnnbuilder_tpu.core import packing as jax_packing
from gnnbuilder_tpu_torch.core import packing
from gnnbuilder_tpu_torch.native import build, lib
from gnnbuilder_tpu_torch.ops.cuda import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(got, *wants, names):
    for want in wants:
        for g, w, name in zip(got, want, names, strict=True):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed,num_nodes,num_edges", [
    (0, 100, 450), (1, 7, 3), (2, 1, 0), (3, 513, 4096)])
def test_sort_and_csr(seed, num_nodes, num_edges):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, num_nodes, num_edges).astype(np.int64)
    r = rng.integers(0, num_nodes, num_edges).astype(np.int64)
    n_pad = ((num_nodes + 1 + 7) // 8) * 8
    e_pad = ((max(num_edges, 1) + 7) // 8) * 8
    args = (s, r, num_nodes, n_pad, e_pad, n_pad - 1)
    _same(packing.sort_and_csr(*args), packing.sort_and_csr_plain(*args),
          jax_packing.sort_and_csr(*args),
          names=["senders", "receivers", "perm", "row_offsets", "in_degree"])


def test_concat_edges():
    rng = np.random.default_rng(7)
    num_graphs = 32
    node_counts = rng.integers(1, 30, num_graphs).astype(np.int64)
    edge_counts = (node_counts * 2).astype(np.int64)
    edge_index = np.concatenate(
        [rng.integers(0, node_counts[g], (2, edge_counts[g]))
         for g in range(num_graphs)], axis=1).astype(np.int64)
    args = (edge_counts, node_counts, edge_index, int(node_counts.sum()))
    _same(packing.concat_graphs(*args), packing.concat_graphs_plain(*args),
          jax_packing.concat_graphs(*args),
          names=["senders", "receivers", "node_graph"])


@pytest.mark.parametrize("seed,num_nodes,num_edges,W", [
    (0, 100, 450, 12), (5, 40, 80, 8)])
def test_build_ell(seed, num_nodes, num_edges, W):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, num_nodes, num_edges).astype(np.int64)
    r = rng.integers(0, num_nodes, num_edges).astype(np.int64)
    n_pad = ((num_nodes + 8) // 8) * 8
    e_pad = ((num_edges + 7) // 8) * 8
    ghost = n_pad - 1
    so, _, _, offs, deg = packing.sort_and_csr_plain(s, r, num_nodes, n_pad,
                                                     e_pad, ghost)
    args = (so, offs, e_pad, max(W, int(deg.max())), ghost)
    _same(packing.build_ell(*args), packing.build_ell_plain(*args),
          jax_packing.build_ell(*args), names=["nbr_nodes", "nbr_edges"])
    # the reverse table goes through both as well
    rargs = (s, r, num_nodes, n_pad, e_pad, ghost, 16)
    _same(packing.build_reverse_ell(*rargs),
          jax_packing.build_reverse_ell(*rargs),
          names=["rev_nbr_nodes", "out_degree"])


def test_out_of_range_endpoint_raises():
    s = np.asarray([0, 9], np.int64)
    r = np.asarray([1, 2], np.int64)
    with pytest.raises(RuntimeError, match="code 1"):
        packing.sort_and_csr(s, r, 4, 8, 8, 7)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ rejects raises with the compiler's message; no g++
    raises; the loader passes either on (no numpy fallback)."""
    bad = tmp_path / "packing.cpp"
    bad.write_text("int gnnb_abi_version() { return 2 }\n")
    monkeypatch.setattr(_build, "_BUILD_ROOT", tmp_path / "root")
    monkeypatch.setattr(build, "SRC", bad)
    with pytest.raises(RuntimeError, match="(?s)build failed.*error"):
        build.build()
    monkeypatch.setattr(lib, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed"):
        packing.sort_and_csr(np.zeros(1, np.int64), np.zeros(1, np.int64),
                             1, 8, 8, 7)
    assert not list((tmp_path / "root").rglob("*.so"))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        build.build()


def test_two_processes_building_at_once_both_load(tmp_path):
    code = (
        "import sys\n"
        "from gnnbuilder_tpu_torch.ops.cuda import _build\n"
        "_build.set_build_root(sys.argv[1])\n"
        "import numpy as np\n"
        "from gnnbuilder_tpu_torch.native import lib\n"
        "lib.load()\n"
        "from gnnbuilder_tpu_torch.native import build\n"
        "out = lib.sort_and_csr(np.asarray([1, 0]), np.asarray([0, 1]), 2,"
        " 8, 8, 7)\n"
        "assert out[3][-1] == 8, out\n"
        "print(build.library_path(build.compiler()))\n")
    root = str(tmp_path / "root")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, root], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert outs[0] == outs[1] and os.path.exists(outs[0])
    # each wrote its own temporary name and renamed it: none is left
    assert [f.name for f in (tmp_path / "root").rglob("*")
            if f.is_file()] == ["libgnnb_packing.so"]
