"""Rank bodies of the port's multi-process tests, and the runner that
starts them (imports no JAX: ``spawn`` re-imports this module in every
rank).

:func:`run_worlds` starts ``world`` ranks with the ``spawn`` start method;
each joins a gloo process group through a ``FileStore`` in the test's
temporary directory (with a timeout), runs every case of the list it is
given in order, and pickles ``{case: result}`` to ``rank{r}.pkl``
(:func:`run_worlds` runs several world sizes at once). A case
that raises records its traceback as ``{"error": text}`` and the rank goes
on, so each parametrised test fails alone. The parent joins the ranks with
a deadline and raises, never hangs, when one does not finish.

The data every case runs on is made here from seeds (numpy), so the test
module feeds the same arrays to the JAX package.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback

import numpy as np

B = 16
HW = 32
FEATURES = (8, 16)


# -- data ------------------------------------------------------------------------


def messages(n=12, batch=B, seed=0):
    """A recorded stream of raw prebatched messages (the JAX mesh tests')."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append({
            "_prebatched": True, "btid": 0,
            "image": rng.integers(0, 255, (batch, HW, HW, 4), np.uint8),
            "xy": (rng.random((batch, 8, 2)) * HW).astype(np.float32),
        })
    return out


def frames(n=35):
    rng = np.random.default_rng(1)
    return [{"btid": 0, "frameid": i,
             "image": rng.integers(0, 255, (HW, HW, 4), np.uint8),
             "xy": (rng.random((8, 2)) * HW).astype(np.float32)}
            for i in range(n)]


def tile_messages(n=6, batch=8):
    """A recorded tile-delta stream with (16, 32) tiles (the JAX mesh
    tests'), encoded with the port's host half."""
    from blendjax_torch.ops.tiles import (
        TILEIDX_SUFFIX,
        TILEREF_SUFFIX,
        TILES_SUFFIX,
        TILESHAPE_SUFFIX,
        TileDeltaEncoder,
        pack_batch,
    )

    rng = np.random.default_rng(3)
    ref = rng.integers(0, 255, (HW, HW, 4), np.uint8)
    enc = TileDeltaEncoder(ref, tile=(16, 32))
    out = []
    for k in range(n):
        imgs = []
        for i in range(batch):
            img = ref.copy()
            img[8:16, 8:16] = (7 + 13 * i + 29 * k) % 251
            imgs.append(img)
        deltas = [tuple(a.copy() for a in enc.encode(f)) for f in imgs]
        idx, tiles = pack_batch(deltas, enc.num_tiles, capacity=4)
        msg = {
            "_prebatched": True, "btid": 0,
            "image" + TILEIDX_SUFFIX: idx,
            "image" + TILES_SUFFIX: tiles,
            "image" + TILESHAPE_SUFFIX: [HW, HW, 4, 16, 32],
            "xy": (np.random.default_rng(k).random((batch, 8, 2)) * HW
                   ).astype(np.float32),
        }
        if k == 0:
            msg["image" + TILEREF_SUFFIX] = ref
        out.append(msg)
    return out


def attention_inputs(seed=3, b=4, t=16, h=4, d=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32)
            for _ in range(4)]  # q, k, v and the output cotangent


# -- the runner --------------------------------------------------------------------


def run_worlds(worlds: dict, tmp: str, timeout: float = 150.0) -> dict:
    """Run ``{world size: cases}`` (cases ``[(name, kwargs)]``), every world
    at once, each on its own gloo process group; returns ``{world size:
    [{name: result} per rank]}``. Raises if a rank fails or a world does
    not finish within ``timeout`` seconds (its ranks are killed)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    started = {}
    for world, cases in worlds.items():
        wdir = os.path.join(tmp, f"world{world}")
        os.makedirs(wdir, exist_ok=True)
        store = os.path.join(wdir, "store")
        started[world] = (wdir, [
            ctx.Process(target=rank_main, args=(r, world, store, wdir, cases),
                        daemon=True) for r in range(world)])
    for _wdir, procs in started.values():
        for p in procs:
            p.start()
    deadline = time.monotonic() + timeout
    for _wdir, procs in started.values():
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for _w, procs in started.values() for p in procs
             if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5.0)
    if alive:
        raise AssertionError(
            f"{len(alive)} ranks did not finish in {timeout} s")
    out = {}
    for world, (wdir, procs) in started.items():
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(wdir, f"rank{r}.pkl")
            if p.exitcode != 0 or not os.path.exists(path):
                err = os.path.join(wdir, f"rank{r}.err")
                text = open(err).read() if os.path.exists(err) else ""
                raise AssertionError(
                    f"world {world} rank {r} exited {p.exitcode}: {text}")
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        out[world] = results
    return out


def rank_main(rank: int, world: int, store: str, tmp: str, cases) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        out = {}
        for name, kwargs in cases:
            fn = CASES[name.split(":")[0]]
            try:
                out[name] = fn(**kwargs)
            except Exception:
                out[name] = {"error": traceback.format_exc()}
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# -- helpers of the rank side ---------------------------------------------------------


def _mesh(axes):
    from blendjax_torch.parallel import create_mesh

    return create_mesh(axes, devices="cpu")


def _np(t):
    return t.detach().float().numpy().copy()


def _cube(params_np):
    import torch

    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.weights import from_flax

    m = CubeRegressor(features=FEATURES, dtype=torch.float32)
    m.load_state_dict(from_flax(params_np))
    return m


# -- cases: the parallel modules ---------------------------------------------------------


def case_mesh(specs):
    from blendjax_torch.parallel.mesh import mesh_shape

    out = {}
    for spec in specs:
        try:
            out[repr(spec)] = mesh_shape(_mesh(spec))
        except ValueError as e:
            out[repr(spec)] = f"ValueError: {e}"
    return out


def case_collectives(n):
    """Sum, mean, gather and permute of this rank's shard of a global
    (2n, 3) array over ``data``, with their gradients."""
    import torch

    from blendjax_torch.parallel import (
        all_gather,
        all_reduce_mean,
        all_reduce_sum,
        ring_permute,
    )
    from blendjax_torch.parallel.mesh import axes_index

    mesh = _mesh({"data": n})
    r = axes_index(mesh, "data")
    x_all = np.arange(2 * n * 3, dtype=np.float32).reshape(2 * n, 3)
    w3 = np.random.default_rng(0).random((2, 3)).astype(np.float32)
    wn = np.random.default_rng(1).random((2 * n, 3)).astype(np.float32)
    out = {}
    for name, fn, w in (
        ("sum", lambda x: all_reduce_sum(x, mesh, "data"), w3),
        ("mean", lambda x: all_reduce_mean(x, mesh, "data"), w3),
        ("gather", lambda x: all_gather(x, mesh, "data"), wn),
        ("permute", lambda x: ring_permute(x, mesh, "data"), wn[2 * r:2 * r + 2]),
    ):
        x = torch.from_numpy(x_all[2 * r:2 * r + 2].copy()).requires_grad_()
        y = fn(x)
        (y * torch.from_numpy(w)).sum().backward()
        out[name] = (_np(y), _np(x.grad))
    return out


def case_attention(kind, causal, axes):
    """This rank's block of ring or Ulysses attention on a ``data x seq``
    mesh, and its gradients for the cotangent ``g``."""
    import torch

    from blendjax_torch.parallel import ring_attention, ulysses_attention
    from blendjax_torch.parallel.mesh import axes_index, mesh_shape

    mesh = _mesh(axes)
    shape = mesh_shape(mesh)
    q, k, v, g = attention_inputs()
    nd, ns = shape.get("data", 1), shape.get("seq", 1)
    di, si = axes_index(mesh, "data"), axes_index(mesh, "seq")
    bl, tl = q.shape[0] // nd, q.shape[1] // ns

    def mine(a):
        return torch.from_numpy(
            a[di * bl:(di + 1) * bl, si * tl:(si + 1) * tl].copy())

    qt, kt, vt = (mine(a).requires_grad_() for a in (q, k, v))
    fn = ring_attention if kind == "ring" else ulysses_attention
    kw = {} if kind == "ring" else {"backend": "xla"}
    o = fn(qt, kt, vt, mesh, axis="seq", causal=causal, **kw)
    (o * mine(g)).sum().backward()
    return {"where": (di, si, bl, tl), "o": _np(o), "dq": _np(qt.grad),
            "dk": _np(kt.grad), "dv": _np(vt.grad)}


def case_former_grad(params_np, images, axes):
    """One loss and gradient of a Ulysses StreamFormer on a data x seq mesh
    (flax weights): the global mean of ``out ** 2`` over the batch, this
    rank's rows through it; gradients summed over ``data``."""
    import torch

    from blendjax_torch.models import StreamFormer
    from blendjax_torch.parallel import all_reduce_mean, all_reduce_sum
    from blendjax_torch.parallel.mesh import axes_index, mesh_shape
    from blendjax_torch.weights import streamformer_from_flax

    mesh = _mesh(axes)
    nd = mesh_shape(mesh).get("data", 1)
    di = axes_index(mesh, "data")
    model = StreamFormer(patch=8, dim=32, depth=1, num_heads=4,
                         num_outputs=16, dtype=torch.float32,
                         attn_backend="xla", image_shape=(32, 32),
                         use_ring=True, sp_mode="ulysses", mesh=mesh)
    model.load_state_dict(streamformer_from_flax(params_np))
    bl = images.shape[0] // nd
    x = torch.from_numpy(images[di * bl:(di + 1) * bl].copy())
    loss = all_reduce_mean((model(x) ** 2).mean(), mesh, "data")
    loss.backward()
    grads = {n: _np(all_reduce_sum(p.grad, mesh, "data",
                                   differentiable=False))
             for n, p in model.named_parameters()}
    return {"loss": float(loss), "grads": grads}


def case_ring_bf16(params_np, images, axes, steps=3):
    """Per-update losses of a bf16 StreamFormer through ring attention on
    a ``seq`` mesh, and of the same model with local attention, from the
    same flax weights on the same batch."""
    import torch

    from blendjax_torch.models import StreamFormer
    from blendjax_torch.train import make_supervised_step, make_train_state
    from blendjax_torch.weights import streamformer_from_flax

    mesh = _mesh(axes)
    batch = {"image": torch.from_numpy(images),
             "xy": torch.from_numpy(np.random.default_rng(6).uniform(
                 0, 32, (images.shape[0], 8, 2)).astype(np.float32))}

    def loss(model, b):
        out = model(b["image"]).reshape(-1, 8, 2)
        return ((out - b["xy"] / 32.0) ** 2).mean()

    out = {}
    for name, sp in (("ring", {"use_ring": True, "mesh": mesh}),
                     ("local", {})):
        model = StreamFormer(patch=8, dim=32, depth=1, num_heads=4,
                             num_outputs=16, dtype=torch.bfloat16,
                             attn_backend="xla", image_shape=(32, 32), **sp)
        model.load_state_dict(streamformer_from_flax(params_np))
        state = make_train_state(model, device="cpu")
        step = make_supervised_step(loss_fn=loss)
        out[name] = [float(step(state, batch)[1]["loss"])
                     for _ in range(steps)]
    return out


def case_decode(axes):
    """The sharded decode: this rank's rows of a tile batch through
    ``decode_tile_delta(mesh=)`` and of a packed group through
    ``decode_packed_superbatch(mesh=)`` (the kernels' plain twins here)."""
    import torch

    from blendjax_torch.ops import tiles as T
    from blendjax_torch.parallel.mesh import axes_index, mesh_shape

    mesh = _mesh(axes)
    msgs = tile_messages(2, batch=8)
    ref = torch.from_numpy(msgs[0]["image" + T.TILEREF_SUFFIX])
    ref_tiles = T.tile_ref(ref, (16, 32))
    idx = torch.from_numpy(msgs[1]["image" + T.TILEIDX_SUFFIX])
    tiles = torch.from_numpy(msgs[1]["image" + T.TILES_SUFFIX])
    one = T.decode_tile_delta(ref_tiles, idx, tiles, (HW, HW, 4), mesh=mesh,
                              data_axis="data")
    fields = {"image" + T.TILEIDX_SUFFIX: msgs[1]["image" + T.TILEIDX_SUFFIX],
              "image" + T.TILES_SUFFIX: msgs[1]["image" + T.TILES_SUFFIX],
              "xy": msgs[1]["xy"]}
    buf, spec = T.pack_fields(fields)
    packed = torch.from_numpy(np.stack([buf, buf]))
    sb = T.decode_packed_superbatch(
        packed, {"image": ref_tiles}, spec, ("image",),
        ((HW, HW, 4, 16, 32),), mesh=mesh, data_axis="data")
    try:
        T.decode_tile_delta(ref_tiles, idx[:7], tiles[:7], (HW, HW, 4),
                            mesh=mesh, data_axis="data")
        odd = None
    except ValueError as e:
        odd = str(e)
    return {"rank": axes_index(mesh, "data"),
            "ways": mesh_shape(mesh)["data"], "one": one.numpy().copy(),
            "image": sb["image"].numpy().copy(), "xy": sb["xy"].numpy().copy(),
            "odd": odd}


def case_collective_bytes(params_np, axes):
    """The collectives of one mesh supervised step (a CubeRegressor) and of
    one Ulysses attention call, by kind and axis."""
    import torch

    from blendjax_torch.parallel import ulysses_attention
    from blendjax_torch.parallel.collectives import recording
    from blendjax_torch.train import make_mesh_supervised_step, make_train_state

    mesh = _mesh(axes)
    state = make_train_state(_cube(params_np), device="cpu", mesh=mesh)
    step = make_mesh_supervised_step(state, mesh, precision="f32")
    batch = {k: torch.from_numpy(v[:4]) for k, v in messages(1)[0].items()
             if isinstance(v, np.ndarray)}
    with recording() as tally:
        step(state, batch)
    q = torch.zeros(2, 8, 4, 8)
    with recording() as a2a:
        ulysses_attention(q, q, q, mesh, axis="seq", backend="xla")
    params = sum(p.numel() for p in state.model.parameters())
    return {"step": tally, "ulysses": a2a, "param_numel": int(params)}


def case_ulysses_heads(axes):
    """Ulysses refuses heads the seq axis does not divide."""
    import torch

    from blendjax_torch.parallel import ulysses_attention

    mesh = _mesh(axes)
    x = torch.zeros(1, 4, 3, 8)
    try:
        ulysses_attention(x, x, x, mesh, axis="seq")
    except ValueError as e:
        return str(e)
    return None


def case_shard_params(axes):
    """``shard_params`` on a dense kernel and a bias: each rank's DTensor
    shard, its placements, and the full tensor gathered back."""
    import torch

    from blendjax_torch.parallel import shard_params

    mesh = _mesh(axes)
    full = {"dense/kernel": torch.arange(256 * 128, dtype=torch.float32)
            .reshape(256, 128), "b": torch.ones(7)}
    placed = shard_params(mesh, full)
    return {k: {"local": tuple(v.to_local().shape),
                "placements": [repr(p) for p in v.placements],
                "equal": bool(torch.equal(v.full_tensor(), full[k]))}
            for k, v in placed.items()}


def case_fleet():
    from blendjax_torch.obs.fleetview import (
        fleet_report,
        gather_fleet_snapshots,
    )

    snaps = gather_fleet_snapshots(driver={"host_blocks": 0})
    return {"processes": [s["process"] for s in snaps],
            "counts": [s["processes"] for s in snaps],
            "report": fleet_report(snaps)}


# -- cases: the mesh driver -------------------------------------------------------------------


def _drive(params_np, axes, n_msgs=10, layout=None, fused=False,
           chunk=1):
    import torch

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.parallel import state_resident_bytes
    from blendjax_torch.train import MeshTrainDriver
    from blendjax_torch.utils.metrics import metrics

    metrics.reset()
    mesh = _mesh(axes)
    drv = MeshTrainDriver.build(
        _cube(params_np), mesh, np.zeros((B, HW, HW, 4), np.uint8),
        layout=layout, device="cpu", sync_every=1, inflight=2, fused=fused,
        flops_per_image=1e6, peak_flops_per_chip=1e12)
    if fused:
        source = tile_messages(n_msgs, 8)
        batch = 8
    else:
        source = messages(n_msgs)
        batch = B
    with StreamDataPipeline(iter(source), batch_size=batch, mesh=mesh,
                            device="cpu", chunk=chunk,
                            emit_packed=fused) as pipe:
        for sb in pipe:
            drv.submit(sb)
    drv.finish()
    fleet = drv.fleet_report()
    spans = metrics.report()["spans"]
    specs = [s.spec for s in (drv.state.shards.specs
                              if drv.state.shards else [])]
    return {
        "losses": np.concatenate([np.ravel(v) for v in drv.losses]),
        "dispatches": drv.dispatches, "steps": drv.steps,
        "train_dispatch": spans.get("train.dispatch", {}).get("count", 0),
        "decode_dispatch": spans.get("decode.dispatch", {}).get("count", 0),
        "stats": {k: drv.stats[k] for k in ("chips", "processes", "layout",
                                            "data_axis_size")},
        "images_retired": drv.images_retired,
        "peak_flops": drv.peak_flops,
        "fleet": (fleet["processes"], sorted(fleet["verdicts"])),
        "specs": specs,
        "resident": state_resident_bytes(drv.state),
        "tally": drv.collective_tally,
        "lead": int(sb["image"].shape[0]) if "image" in sb else None,
        "grads_finite": all(bool(torch.isfinite(s).all())
                            for s in drv.state.model.parameters()),
    }


def case_drive(params_np, axes, **kw):
    return _drive(params_np, axes, **kw)


def case_live(params_np, axes, counts=None, n_msgs=10):
    """Live producers on a mesh: each rank publishes its rows of the
    recorded global batches from a publisher of its own (rank ``r``:
    ``counts[r]`` messages) and trains on what its pipeline assembles from
    that producer alone."""
    import threading

    import torch.distributed as dist

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.producer.publisher import DataPublisher
    from blendjax_torch.train import MeshTrainDriver

    mesh = _mesh(axes)
    rank, world = dist.get_rank(), dist.get_world_size()
    rows = slice(rank * (B // world), (rank + 1) * (B // world))
    n = counts[rank] if counts else n_msgs
    pub = DataPublisher("tcp://127.0.0.1:*", btid=rank)
    mine = [{"_prebatched": True, "image": m["image"][rows],
             "xy": m["xy"][rows]} for m in messages(n_msgs)[:n]]
    sender = threading.Thread(
        target=lambda: [pub.publish(**m) for m in mine], daemon=True)
    sender.start()
    drv = MeshTrainDriver.build(_cube(params_np), mesh, None, device="cpu",
                                sync_every=1, inflight=2)
    leads = []
    with StreamDataPipeline([pub.addr], batch_size=B, mesh=mesh,
                            device="cpu", max_items=n,
                            timeoutms=30_000) as pipe:
        for sb in pipe:
            leads.append(int(sb["image"].shape[0]))
            drv.submit(sb)
    drv.finish()
    sender.join(30.0)
    if not sender.is_alive():  # never close a socket under its sender
        pub.close()
    return {"losses": np.asarray(drv.losses), "steps": drv.steps,
            "leads": leads, "rank_batch": pipe.rank_batch,
            "messages": pipe.messages}


def case_live_refused(axes):
    """Live producers need every rank to hold its own rows: a model axis
    that does not split the batch (tp) is refused, by name."""
    from blendjax_torch.data import StreamDataPipeline

    try:
        StreamDataPipeline(["tcp://127.0.0.1:1"], batch_size=B,
                           mesh=_mesh(axes), device="cpu")
    except ValueError as e:
        return str(e)
    return None


def case_pipeline_rules(axes):
    """Batch divisibility and mesh-divisible padding of a ragged tail."""
    from blendjax_torch.data import StreamDataPipeline

    mesh = _mesh(axes)
    try:
        StreamDataPipeline(iter([]), batch_size=B - 1, mesh=mesh,
                           device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    with StreamDataPipeline(iter(frames()), batch_size=B, mesh=mesh,
                            device="cpu", emit_partial_final=True) as pipe:
        batches = list(pipe)
    return {"refused": refused,
            "leads": [int(b["image"].shape[0]) for b in batches],
            "tail_mask": batches[-1]["_mask"].numpy().copy()}


def case_reservoir(params_np, axes):
    """The sharded reservoir: local layout, stable storage, capacity
    divisibility, scripted draws through a mesh step."""
    from blendjax_torch.data import SampleReservoir
    from blendjax_torch.testing.donation import tree_pointers
    from blendjax_torch.parallel import ring_sharding
    from blendjax_torch.parallel.sharding import local_rows
    from blendjax_torch.train import MeshTrainDriver

    mesh = _mesh(axes)
    sh = ring_sharding(mesh)
    out = {}
    try:
        SampleReservoir(33, sharding=sh, device="cpu")
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    res = SampleReservoir(64, augment=None, rng=7, sharding=sh, device="cpu")
    drv = MeshTrainDriver.build(_cube(params_np), mesh, None, device="cpu",
                                sync_every=1, inflight=1)
    idx_rng = np.random.default_rng(11)
    ptrs = None
    for hb in messages(4):
        rows = {"image": local_rows(hb["image"], sh),
                "xy": local_rows(hb["xy"], sh)}
        res.insert(rows)
        ptrs = ptrs or tree_pointers(res.device_buffers())
        for _ in range(2):
            idx = idx_rng.integers(0, res.size, B)
            drv.submit(res.sample(idx))
    drv.finish()
    out["ring_rows"] = int(res._buffers["image"].shape[0])
    out["stable"] = tree_pointers(res.device_buffers()) == ptrs
    out["losses"] = np.asarray(drv.losses)
    out["drawn_lead"] = int(res.sample(np.arange(B))["image"].shape[0])
    out["gather"] = res.gather(np.arange(B))["xy"].numpy().copy()
    return out


def case_echo(params_np, axes, n_msgs=6, factor=4):
    """An EchoingPipeline on a mesh, run to exhaustion (capacity holds
    every sample): exact accounting, one dispatch per draw."""
    from blendjax_torch.data import EchoingPipeline, StreamDataPipeline
    from blendjax_torch.train import MeshTrainDriver

    mesh = _mesh(axes)
    inner = StreamDataPipeline(iter(messages(n_msgs)), batch_size=B,
                               mesh=mesh, device="cpu")
    echo = EchoingPipeline(inner, capacity=n_msgs * B,
                           max_echo_factor=factor, augment=None, mesh=mesh,
                           batch_size=B)
    drv = MeshTrainDriver.build(_cube(params_np), mesh, None, device="cpu",
                                sync_every=1, inflight=2)
    with echo:
        for sb in echo:
            drv.submit(sb)
    drv.finish()
    try:
        EchoingPipeline([], capacity=16, mesh=mesh, batch_size=B - 1,
                        device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"inserted": echo.inserted, "fresh": echo.fresh,
            "echoed": echo.echoed, "steps": echo.steps,
            "dispatches": drv.dispatches, "refused": refused,
            "losses": np.asarray(drv.losses)}


def case_snapshot(params_np, axes, layout, path):
    """A sharded state after 2 updates, gathered to the one-card leaves
    (rank 0 saves them as a snapshot), then loaded back onto the mesh."""
    import torch

    from blendjax_torch.checkpoint import SnapshotManager
    from blendjax_torch.train import MeshTrainDriver
    from blendjax_torch.weights import (
        load_train_state_leaves,
        train_state_leaves,
    )

    mesh = _mesh(axes)
    drv = MeshTrainDriver.build(_cube(params_np), mesh, None, layout=layout,
                                device="cpu", sync_every=1, inflight=1)
    for hb in messages(2):
        drv.submit({k: torch.from_numpy(v[:B]) for k, v in hb.items()
                    if isinstance(v, np.ndarray)} | {"btid": 0})
    drv.finish()
    leaves = {k: (v.detach().numpy().copy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in
              train_state_leaves(drv.state).items()}
    import torch.distributed as dist

    if dist.get_rank() == 0:
        mgr = SnapshotManager(path)
        mgr.save(2, leaves)
        mgr.wait()
        mgr.close()
    dist.barrier()
    # load back onto the mesh: perturb, restore, gather again
    with torch.no_grad():
        for shard in drv.state.shards.shards:
            shard.add_(1.0)
    load_train_state_leaves(drv.state, leaves)
    again = {k: (v.detach().numpy().copy() if isinstance(v, torch.Tensor)
                 else np.asarray(v)) for k, v in
             train_state_leaves(drv.state).items()}
    same = all(np.array_equal(again[k], leaves[k]) for k in leaves)
    return {"leaves": leaves, "reloaded_equal": same,
            "sharded": any(s.sharded for s in drv.state.shards.specs)}


# -- cases: pipeline and expert parallelism ------------------------------------------------


def pipe_inputs(n_stages, m=4, mb=4, dim=8, seed=0):
    """Per-stage ``{"w", "b"}`` of a shape-preserving MLP stage and the
    (M, mb, dim) microbatches (the JAX pipeline tests' shapes)."""
    rng = np.random.default_rng(seed)
    stages = [{"w": (rng.normal(size=(dim, dim)) / np.sqrt(dim)
                     ).astype(np.float32),
               "b": (rng.normal(size=dim) * 0.1).astype(np.float32)}
              for _ in range(n_stages)]
    x = rng.normal(size=(m, mb, dim)).astype(np.float32)
    return stages, x


def pipe_stage(params, x):
    """One shape-preserving MLP stage: gelu(x @ w + b) in its tanh form
    (``jax.nn.gelu``'s default, the JAX pipeline tests' stage)."""
    import torch

    return torch.nn.functional.gelu(x @ params["w"] + params["b"],
                                    approximate="tanh")


def case_pipeline(axes, n_stages, seed=0, m=4, mb=4):
    """``pipeline_apply`` over ``axes``: the outputs, the loss mean(y^2)
    (over this rank's rows: a ``data`` axis splits the microbatch dim), the
    input gradient and the stacked parameters' gradients summed over the
    ``pipe`` axis (each rank holds its stage's slice); the same through
    the stages applied one after another on this rank."""
    import torch

    from blendjax_torch.parallel import (
        all_reduce_sum,
        pipeline_apply,
        stack_stage_params,
    )
    from blendjax_torch.parallel.mesh import axes_index, mesh_shape

    mesh = _mesh(axes)
    shape = mesh_shape(mesh)
    stages, x = pipe_inputs(n_stages, m=m, mb=mb, seed=seed)
    nd = shape.get("data", 1)
    di = axes_index(mesh, "data") if "data" in shape else 0
    rows = slice(di * (mb // nd), (di + 1) * (mb // nd))
    out = {"where": (di, nd)}
    for name in ("pipe", "sequential"):
        st = {k: v.detach().clone().requires_grad_() for k, v in
              stack_stage_params([{k: torch.from_numpy(v) for k, v in
                                   s.items()} for s in stages]).items()}
        xt = torch.from_numpy(x[:, rows].copy()).requires_grad_()
        if name == "pipe":
            y = pipeline_apply(pipe_stage, st, xt, mesh, axis="pipe")
        else:
            y = pipeline_apply(pipe_stage, st, xt, mesh, axis="no-such-axis")
        (y ** 2).mean().backward()
        grads = {k: v.grad for k, v in st.items()}
        if name == "pipe" and "pipe" in shape:
            grads = {k: all_reduce_sum(g, mesh, "pipe", differentiable=False)
                     for k, g in grads.items()}
        out[name] = {"y": _np(y), "dx": _np(xt.grad),
                     "dw": _np(grads["w"]), "db": _np(grads["b"])}
    return out


def case_pipeline_blocks(axes, seed=0):
    """A StreamFormer ``Block`` per stage through ``functional_call`` over
    the stacked block parameters (the documented recipe): outputs and the
    input gradient against the blocks applied one after another, and the
    blocks' own ``.grad`` filled through ``torch.stack``."""
    import torch

    from blendjax_torch.models import Block
    from blendjax_torch.parallel import (
        all_reduce_sum,
        pipeline_apply,
        stack_stage_params,
    )
    from blendjax_torch.parallel.mesh import mesh_shape

    mesh = _mesh(axes)
    n = mesh_shape(mesh)["pipe"]
    torch.manual_seed(seed)
    blocks = [Block(16, 4, dtype=torch.float32, attn_backend="xla")
              for _ in range(n)]
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(3, 2, 8, 16)).astype(np.float32))

    def stage_fn(params, v):
        return torch.func.functional_call(blocks[0], params, (v,))

    stacked = stack_stage_params([dict(b.named_parameters()) for b in blocks])
    xa = x.clone().requires_grad_()
    y = pipeline_apply(stage_fn, stacked, xa, mesh, axis="pipe")
    (y ** 2).mean().backward()
    got = {name: all_reduce_sum(p.grad if p.grad is not None
                                else torch.zeros_like(p), mesh, "pipe",
                                differentiable=False)
           for i, b in enumerate(blocks)
           for name, p in ((f"{i}.{k}", q) for k, q in b.named_parameters())}
    for b in blocks:
        b.zero_grad()
    xb = x.clone().requires_grad_()
    ys = []
    for m in range(x.shape[0]):
        v = xb[m]
        for b in blocks:
            v = b(v)
        ys.append(v)
    (torch.stack(ys) ** 2).mean().backward()
    want = {f"{i}.{k}": q.grad for i, b in enumerate(blocks)
            for k, q in b.named_parameters()}
    return {"dy": float((y - torch.stack(ys)).abs().max()),
            "dx": float((xa.grad - xb.grad).abs().max()),
            "dparams": max(float((got[k] - want[k]).abs().max())
                           for k in want)}


def case_pipeline_mismatch(axes, n_stages):
    """Stacked stages that do not match the ``pipe`` axis raise."""
    import torch

    from blendjax_torch.parallel import pipeline_apply, stack_stage_params

    stages, x = pipe_inputs(n_stages)
    st = stack_stage_params([{k: torch.from_numpy(v) for k, v in s.items()}
                             for s in stages])
    try:
        pipeline_apply(pipe_stage, st, torch.from_numpy(x), _mesh(axes))
    except ValueError as e:
        return str(e)
    return None


def former_messages(n=4, batch=8, hw=32, seed=5):
    """Recorded prebatched messages for the MoE StreamFormer cases."""
    rng = np.random.default_rng(seed)
    return [{"_prebatched": True, "btid": 0,
             "image": rng.integers(0, 255, (batch, hw, hw, 4), np.uint8),
             "xy": (rng.random((batch, 8, 2)) * hw).astype(np.float32)}
            for _ in range(n)]


FORMER_MOE = dict(patch=8, dim=32, depth=2, num_heads=4, num_outputs=16,
                  num_experts=4)


def former_loss(model, batch):
    from blendjax_torch.train import corner_loss

    return corner_loss(model(batch["image"]).reshape(-1, 8, 2), batch["xy"],
                       image_shape=tuple(batch["image"].shape[1:3]))


def case_expert(params_np, axes, n_msgs=4):
    """A MoE StreamFormer through ``MeshTrainDriver.build`` on a ``data``
    or ``data x expert`` mesh (the state-only expert layout: ``expert_*``
    sharded, gathered before each update), its losses, the shard specs,
    the refusal of ``aot=True``, and the first batch's loss with each rank
    routing its own tokens alone (``local_first_loss``: per-rank capacity
    and queue positions, which the mesh step must not use)."""
    import torch

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.models.moe import apply_with_aux, route_over_batch
    from blendjax_torch.parallel import all_reduce_mean
    from blendjax_torch.parallel.sharding import batch_sharding, local_rows
    from blendjax_torch.train import MeshTrainDriver
    from blendjax_torch.weights import streamformer_from_flax

    mesh = _mesh(axes)

    def model():
        m = StreamFormer(**FORMER_MOE, dtype=torch.float32,
                         attn_backend="xla", image_shape=(32, 32))
        m.load_state_dict(streamformer_from_flax(params_np))
        return m

    first = {k: local_rows(torch.from_numpy(v), batch_sharding(mesh))
             for k, v in former_messages(n_msgs)[0].items()
             if k in ("image", "xy")}
    with torch.no_grad():
        local_first = float(all_reduce_mean(
            former_loss(model(), first), mesh, "data"))
    # the aux loss routed over the global batch, and block 0's router
    # gradient of it averaged over the ranks (as the mesh step averages)
    m = model()
    route_over_batch(m, mesh, ("data",))
    _out, aux = apply_with_aux(m, first["image"], aux_weight=1.0)
    aux.backward()
    router_grad = all_reduce_mean(m.blocks[0].moe.router.weight.grad, mesh,
                                  "data")

    drv = MeshTrainDriver.build(model(), mesh, device="cpu",
                                loss_fn=former_loss, sync_every=1,
                                inflight=1)
    with StreamDataPipeline(iter(former_messages(n_msgs)), batch_size=8,
                            mesh=mesh, device="cpu") as pipe:
        for sb in pipe:
            drv.submit(sb)
    drv.finish()
    refused = None
    if "expert" in axes:  # a state sharded over a model axis
        try:
            MeshTrainDriver.build(model(), mesh, device="cpu",
                                  loss_fn=former_loss, aot=True)
        except ValueError as e:
            refused = str(e)
    shards = drv.state.shards
    names = {id(p): n for n, p in drv.state.model.named_parameters()}
    return {"losses": np.asarray(drv.losses),
            "specs": {str(sh.spec) for sh in shards.specs if sh.sharded}
            if shards else set(),
            "expert_local": [tuple(s.shape) for p, s in zip(
                shards.params, shards.shards) if ".expert_" in names[id(p)]]
            if shards else [],
            "layout": drv.stats["layout"], "refused": refused,
            "local_first_loss": local_first, "aux": float(aux),
            "aux_router_grad": router_grad.numpy().T.copy()}


# -- cases: RL -----------------------------------------------------------------------------


def rl_inserts(n=6, rows=8, seed=0, with_ret=False):
    """A scripted sequence of transition batches (the reference test's
    fields)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"obs": rng.normal(size=(rows, 4)).astype(np.float32),
             "action": rng.integers(0, 3, size=rows).astype(np.int32),
             "reward": rng.normal(size=rows).astype(np.float32),
             "done": rng.random(rows) < 0.2,
             "next_obs": rng.normal(size=(rows, 4)).astype(np.float32)}
        if with_ret:
            b["ret"] = rng.normal(size=rows).astype(np.float32)
        out.append(b)
    return out


def case_rl_mesh(params_np, prioritized=False, capacity=64, batch=16,
                 steps_per_insert=2, seed=0):
    """The mesh learner on a scripted insert sequence: rank 0 inserts (the
    actor rank), every rank agrees on the inserts before each compose,
    trains its rows of each draw and all-reduces the gradients; the
    losses, the final parameters, the priorities and the accounting."""
    import torch.distributed as dist

    from blendjax_torch.models import QNetwork
    from blendjax_torch.rl import (
        RLTrainDriver,
        TrajectoryReservoir,
        make_dqn_step,
        make_rl_train_state,
        mesh_rl_step_kwargs,
    )
    from blendjax_torch.weights import flax_tree, policy_from_flax

    mesh = _mesh({"data": -1})
    res = TrajectoryReservoir(capacity, rng=seed, mesh=mesh, device="cpu",
                              prioritized=prioritized)
    model = QNetwork(hidden=(16,), n_actions=3)
    model.load_state_dict(policy_from_flax(params_np))
    state = make_rl_train_state(model, device="cpu", mesh=mesh)
    step = make_dqn_step(res, gamma=0.98, **mesh_rl_step_kwargs(state, mesh))
    drv = RLTrainDriver(step, state, res, mesh=mesh, batch_size=batch,
                        min_fill=8, sync_every=1, inflight=1,
                        sample_timeout_s=30.0)
    for ins in rl_inserts():
        if dist.get_rank() == 0:
            res.insert(ins)
        for _ in range(steps_per_insert):
            drv.train_step()
    drv.drain()
    return {"losses": np.asarray(drv.losses), "params": flax_tree(model),
            "target": flax_tree(state.target),
            "prio": res._priorities.numpy().copy(), "stats": res.stats,
            "ring_rows": int(res._buffers["obs"].shape[0]),
            "steps": drv.steps, "images": drv.images_retired}


def case_equivalence(layout, seed=0):
    """``assert_sharded_matches_single_device`` of the port's equivalence
    scaffold on ``layout``'s mesh: two CubeRegressors from one seed, one
    batch from ``seed`` (every rank the same), the sharded one through
    ``make_train_state(mesh=)``. Returns the loss and gradient differences
    and whether some parameter's layout names ``fsdp``."""
    import torch

    from blendjax_torch.models import CubeRegressor
    from blendjax_torch.parallel import resolve_layout
    from blendjax_torch.parallel.sharding import model_shardings
    from blendjax_torch.testing.equivalence import (
        assert_sharded_matches_single_device,
        loss_and_grads,
        normalized_spec,
    )

    mesh = resolve_layout(layout).create_mesh(devices="cpu")
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B // 2, HW, HW, 4), dtype=np.uint8)
    xy = (rng.random((B // 2, 8, 2)) * HW).astype(np.float32)

    def model():
        return CubeRegressor(features=FEATURES,
                             dtype=torch.float32).init_params(seed)

    specs = [normalized_spec(sh) for *_rest, sh in
             model_shardings(model(), mesh)]
    loss_diff, grad_diff = assert_sharded_matches_single_device(
        model(), model(), mesh, images, xy)
    ref_loss, ref_grads = loss_and_grads(model(), images, xy)
    return {"loss_diff": loss_diff, "grad_diff": grad_diff,
            "loss_scale": max(1.0, abs(ref_loss)),
            "grad_scale": max(1.0, max(float(np.abs(g).max())
                                       for g in ref_grads.values())),
            "fsdp": any("fsdp" in s for s in specs)}


CASES = {
    "live": case_live,
    "live_refused": case_live_refused,
    "mesh": case_mesh,
    "collectives": case_collectives,
    "attention": case_attention,
    "former_grad": case_former_grad,
    "decode": case_decode,
    "collective_bytes": case_collective_bytes,
    "fleet": case_fleet,
    "shard_params": case_shard_params,
    "ulysses_heads": case_ulysses_heads,
    "ring_bf16": case_ring_bf16,
    "drive": case_drive,
    "pipeline_rules": case_pipeline_rules,
    "reservoir": case_reservoir,
    "echo": case_echo,
    "snapshot": case_snapshot,
    "pipeline": case_pipeline,
    "pipeline_blocks": case_pipeline_blocks,
    "pipeline_mismatch": case_pipeline_mismatch,
    "expert": case_expert,
    "rl_mesh": case_rl_mesh,
    "equivalence": case_equivalence,
}
