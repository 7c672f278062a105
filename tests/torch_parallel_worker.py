"""Rank side of ``tests/test_torch_parallel.py``: gloo worlds of CPU
processes running the port's ``parallel`` cases.  Imports torch and the
port only, so each spawned rank starts without JAX.

``World(world, cases, tmp_dir)`` spawns ``world`` ranks (the "spawn"
context; file-based rendezvous under ``tmp_dir``, so concurrent test
workers never contend for a port), which run every case in order;
``results()`` returns each rank's results (lists of dicts of numpy
arrays).
Every queue read and join has a timeout: on expiry the ranks are
terminated and the call raises.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback

import numpy as np

TIMEOUT_S = 240.0


def _np(t):
    return t.detach().cpu().numpy().copy()


def _graphs(spec):
    from gnnbuilder_tpu_torch.data.datasets import FakeDataset

    return FakeDataset(**spec["data"])


def _batch(spec, graphs):
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch

    return build_graph_batch(graphs, device="cpu", **spec.get("pack", {}))


def _model(spec):
    import torch

    from gnnbuilder_tpu_torch.nn.model import GNNModel

    model = GNNModel(**spec["model"])
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in spec["params"].items()})
    return model


def _mesh(spec):
    from gnnbuilder_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dp=spec.get("dp"), tp=spec.get("tp", 1),
                     device_type="cpu")


def case_agg(spec):
    """Sharded aggregation of this rank's rows (overlapped and
    sequential), the single-rank ``ell_multi`` of the whole batch, and
    the errors of a zero halo and of one above the local rows."""
    import torch

    from gnnbuilder_tpu_torch.ops import ell
    from gnnbuilder_tpu_torch.parallel.halo import (
        ell_aggregate_sharded,
        ell_sum_sharded,
    )

    mesh = _mesh(spec)
    b = _batch(spec, _graphs(spec))
    x = torch.as_tensor(spec["x"])
    n = b.num_nodes // mesh.shape["dp"]
    i = mesh.index("dp")
    rows = slice(i * n, (i + 1) * n)
    xl, nbr, deg = x[rows], b.nbr_nodes[rows], b.in_degree[rows]
    aggs = tuple(spec["aggs"])
    h = spec["h"]
    d = ell.ell_multi(x, b.nbr_nodes, b.in_degree, aggs)
    out = {
        "ovl": _np(ell_aggregate_sharded(mesh, xl, nbr, deg, h, aggs,
                                         overlap=True)),
        "seq": _np(ell_aggregate_sharded(mesh, xl, nbr, deg, h, aggs,
                                         overlap=False)),
        "sum": _np(ell_sum_sharded(mesh, xl, nbr, deg, h)),
        "single": _np(torch.cat([d[a] for a in aggs], dim=-1)[rows]),
    }
    for name, bad in (("err_zero", 0), ("err_big", n + 1)):
        try:
            ell_aggregate_sharded(mesh, xl, nbr, deg, bad, aggs)
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def case_exchange(spec):
    """halo_exchange of this rank's rows and its gradient for the
    cotangent block ``ct``."""
    import torch

    from gnnbuilder_tpu_torch.parallel.halo import halo_exchange

    mesh = _mesh(spec)
    x = torch.as_tensor(spec["x"])
    h = spec["h"]
    dp = mesh.shape["dp"]
    n = x.shape[0] // dp
    i = mesh.index("dp")
    xl = x[i * n:(i + 1) * n].clone().requires_grad_(True)
    y = halo_exchange(xl, h, "dp", mesh)
    ct = torch.as_tensor(spec["ct"])
    k = n + 2 * h
    y.backward(ct[i * k:(i + 1) * k])
    return {"y": _np(y), "dx": _np(xl.grad)}


def case_forward(spec):
    """The sharded forward (``halo`` or the all-gather strategy, with
    weights sharded over tp when ``tp`` > 1), its count of
    ``halo_wrap_layer`` calls, and the single-rank forward."""
    import torch

    from gnnbuilder_tpu_torch.parallel import halo as halo_mod
    from gnnbuilder_tpu_torch.parallel.sharding import (
        shard_batch,
        shard_params,
    )
    from gnnbuilder_tpu_torch.parallel.train import make_sharded_forward

    mesh = _mesh(spec)
    b = _batch(spec, _graphs(spec))
    model = _model(spec)
    params = (shard_params(mesh, model.state_dict())
              if mesh.shape["tp"] > 1 else None)
    fwd = make_sharded_forward(model, mesh, b, halo=spec["halo"])
    before = halo_mod.halo_wrap_layer.calls
    with torch.no_grad():
        out = fwd(params, shard_batch(mesh, b, halo=spec["halo"]))
        calls = halo_mod.halo_wrap_layer.calls - before
        single = model(b)
    return {"out": _np(out), "calls": np.int64(calls), "single": _np(single)}


def case_step(spec):
    """One sharded SGD step: the loss and the whole gradient of every
    parameter (tp blocks gathered); the number of reverse CSRs built."""
    import torch

    from gnnbuilder_tpu_torch.ops import ell
    from gnnbuilder_tpu_torch.parallel.sharding import (
        gather_params,
        shard_batch,
    )
    from gnnbuilder_tpu_torch.parallel.train import make_sharded_train_step
    from gnnbuilder_tpu_torch.train import stack_targets

    mesh = _mesh(spec)
    graphs = _graphs(spec)
    b = _batch(spec, graphs)
    model = _model(spec)
    target = stack_targets(graphs, b.num_graphs, device="cpu")
    step, init = make_sharded_train_step(
        model, lambda ps: torch.optim.SGD(ps, lr=1e-2), mesh, b,
        halo=spec["halo"])
    params, opt = init(model.state_dict())
    built = []
    orig = ell.reverse_csr

    def counting(*a, **k):
        built.append(1)
        return orig(*a, **k)

    ell.reverse_csr = counting
    try:
        params, opt, loss = step(params, opt,
                                 shard_batch(mesh, b, halo=spec["halo"]),
                                 target)
    finally:
        ell.reverse_csr = orig
    grads = gather_params(mesh, {k: v.grad for k, v in params.items()},
                          model)
    blocks = sorted(k for k, v in params.items()
                    if tuple(v.shape) != tuple(grads[k].shape))
    return {"loss": _np(loss), "grads": {k: _np(v) for k, v in grads.items()},
            "blocks": blocks, "csr_built": np.int64(len(built))}


def case_meshes(spec):
    """``make_multihost_mesh(tp)`` against ``make_mesh(tp=tp)``, and a
    submesh of width 1: its member's sharded sum against the plain one,
    the other rank outside it."""
    import torch

    from gnnbuilder_tpu_torch.ops import ell
    from gnnbuilder_tpu_torch.parallel.halo import ell_sum_sharded
    from gnnbuilder_tpu_torch.parallel.mesh import (
        make_mesh,
        make_multihost_mesh,
    )

    out = {}
    for tp in spec["tps"]:
        a = make_mesh(tp=tp, device_type="cpu")
        m = make_multihost_mesh(tp=tp, device_type="cpu")
        out[f"same_{tp}"] = np.bool_(
            np.array_equal(a.ranks, m.ranks)
            and a.coordinate == m.coordinate
            and a.group_ranks("dp") == m.group_ranks("dp")
            and a.group_ranks("tp") == m.group_ranks("tp"))
    sub = make_mesh(dp=1, tp=1, device_type="cpu")
    out["member"] = np.bool_(sub.member)
    if sub.member:
        b = _batch(spec, _graphs(spec))
        x = torch.as_tensor(spec["x"])
        got = ell_sum_sharded(sub, x, b.nbr_nodes, b.in_degree, 8)
        out["sub_err"] = np.float64(
            (got - ell.ell_sum(x, b.nbr_nodes, b.in_degree)).abs().max())
    else:
        try:
            sub.index("dp")
            out["outside_raises"] = np.bool_(False)
        except RuntimeError:
            out["outside_raises"] = np.bool_(True)
    return out


def case_placements(spec):
    """The placements of a batch's fields (both strategies) and of a
    p-factor model's parameters."""
    from gnnbuilder_tpu_torch.parallel.sharding import (
        batch_shardings,
        halo_batch_specs,
        model_p_factors,
        param_shardings,
    )

    mesh = _mesh(spec)
    b = _batch(spec, _graphs(spec))
    model = _model(spec)
    pf = model_p_factors(model)
    return {"batch": batch_shardings(mesh, b), "halo": halo_batch_specs(b),
            "p_factors": pf,
            "params": param_shardings(mesh, model.state_dict(), pf)}


def case_scaling(spec):
    """``measure_scaling`` over the world's widths."""
    from gnnbuilder_tpu_torch.parallel.scaling import measure_scaling

    model = _model(spec)
    rows = measure_scaling(model, _graphs(spec), batch_size=8,
                           dp_widths=tuple(spec["widths"]), iters=4,
                           device_type="cpu")
    return {"rows": rows}


CASES = {"agg": case_agg, "exchange": case_exchange,
         "forward": case_forward, "step": case_step,
         "meshes": case_meshes, "placements": case_placements,
         "scaling": case_scaling}


def _rank_main(rank, world, init_file, cases, q):
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        out = []
        for spec in cases:
            t0 = time.perf_counter()
            res = CASES[spec["case"]](spec)
            res["seconds"] = time.perf_counter() - t0
            out.append(res)
        dist.barrier()
        dist.destroy_process_group()
        q.put((rank, out, None))
    except BaseException:
        q.put((rank, None, traceback.format_exc()))


class World:
    """``world`` spawned ranks running ``cases``; ``results()`` waits for
    them (see the module docstring)."""

    def __init__(self, world: int, cases: list, tmp_dir: str,
                 timeout: float = TIMEOUT_S):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.q = ctx.Queue()
        init_file = os.path.join(str(tmp_dir), f"pg_world{world}")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world, init_file, cases, self.q),
                                  daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def results(self) -> list:
        """Every rank's results: ``[rank][case] -> dict``."""
        out = [None] * self.world
        try:
            for _ in range(self.world):
                left = self.deadline - time.monotonic()
                try:
                    rank, res, err = self.q.get(timeout=max(left, 0.1))
                except queue_mod.Empty:
                    raise TimeoutError(f"world of {self.world}: no result "
                                       f"within {self.timeout} s")
                if err is not None:
                    raise RuntimeError(f"rank {rank} failed:\n{err}")
                out[rank] = res
            for p in self.procs:
                p.join(timeout=max(self.deadline - time.monotonic(), 0.1))
                if p.is_alive():
                    raise TimeoutError(f"world of {self.world}: a rank did "
                                       f"not exit")
        finally:
            self.close()
        return out

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
