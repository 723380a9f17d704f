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
    with _param_gathers() as gathers:
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
        "tally": drv.collective_tally, "gathers": gathers[0],
        "lead": int(sb["image"].shape[0]) if "image" in sb else None,
        "grads_finite": all(bool(torch.isfinite(s).all())
                            for s in drv.state.model.parameters()),
    }


def case_drive(params_np, axes, **kw):
    return _drive(params_np, axes, **kw)


def case_live(params_np, axes, counts=None, n_msgs=10):
    """Live producers on a mesh: each data group publishes its rows of the
    recorded global batches from a publisher of its own, in its first rank
    (rank ``r`` of a data-only mesh: ``counts[r]`` messages), and every
    rank trains on what its pipeline yields; on a model axis the group's
    other ranks receive their leader's batches (they are handed the
    leader's address too, which they must not connect to)."""
    import threading

    import torch.distributed as dist

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.parallel.mesh import axes_index, axes_size
    from blendjax_torch.producer.publisher import DataPublisher
    from blendjax_torch.train import MeshTrainDriver

    mesh = _mesh(axes)
    rank = dist.get_rank()
    ways, group = axes_size(mesh, "data"), axes_index(mesh, "data")
    rows = slice(group * (B // ways), (group + 1) * (B // ways))
    n = counts[rank] if counts else n_msgs
    leader = all(axes_index(mesh, a) == 0 for a in axes if a != "data")
    pub = sender = None
    if leader:
        pub = DataPublisher("tcp://127.0.0.1:*", btid=group)
        mine = [{"_prebatched": True, "image": m["image"][rows],
                 "xy": m["xy"][rows]} for m in messages(n_msgs)[:n]]
        sender = threading.Thread(
            target=lambda: [pub.publish(**m) for m in mine], daemon=True)
        sender.start()
    addrs = [None] * dist.get_world_size()
    dist.all_gather_object(addrs, (group, pub.addr if pub else None))
    addr = next(a for g, a in addrs if g == group and a)
    drv = MeshTrainDriver.build(_cube(params_np), mesh, None, device="cpu",
                                sync_every=1, inflight=2)
    leads, xy = [], []
    with StreamDataPipeline([addr], batch_size=B, mesh=mesh,
                            device="cpu", max_items=n,
                            timeoutms=30_000) as pipe:
        for sb in pipe:
            leads.append(int(sb["image"].shape[0]))
            xy.append(sb["xy"].numpy().copy())
            drv.submit(sb)
    drv.finish()
    if sender is not None:
        sender.join(30.0)
        if not sender.is_alive():  # never close a socket under its sender
            pub.close()
    return {"losses": np.asarray(drv.losses), "steps": drv.steps,
            "leads": leads, "rank_batch": pipe.rank_batch,
            "messages": pipe.messages, "xy": xy, "group": group,
            "leader": leader}


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


class _einsum_experts:
    """Record the expert dim of every ``nec,nd->ecd`` dispatch einsum
    run inside (the experts a rank computes)."""

    def __enter__(self):
        import torch

        self.seen, self.orig = [], torch.einsum

        def spy(eq, *ops):
            if eq == "nec,nd->ecd":
                self.seen.append(int(ops[0].shape[1]))
            return self.orig(eq, *ops)

        torch.einsum = spy
        return self.seen

    def __exit__(self, *exc):
        import torch

        torch.einsum = self.orig


class _param_gathers:
    """Count ``ShardedParams``' all-gathers of parameter shards inside."""

    def __enter__(self):
        from blendjax_torch.parallel import sharding

        self.count, self.orig = [0], sharding.gather_full

        def spy(local, sh):
            self.count[0] += 1
            return self.orig(local, sh)

        sharding.gather_full = spy
        return self.count

    def __exit__(self, *exc):
        from blendjax_torch.parallel import sharding

        sharding.gather_full = self.orig


def case_expert(params_np, axes, n_msgs=4):
    """A MoE StreamFormer through ``MeshTrainDriver.build`` on a ``data``
    or ``data x expert`` mesh (``expert_*`` split over ``expert``, each
    rank computing its experts), its losses, the shard specs, the experts
    each dispatch einsum saw, the parameter gathers and the first step
    call's collectives, the losses of the same build with ``aot=True``
    (on a split state; on the CPU its ladder runs the eager step), and
    the first batch's
    loss with each rank routing its own tokens alone
    (``local_first_loss``: per-rank capacity and queue positions, which
    the mesh step must not use)."""
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
    with _einsum_experts() as experts, _param_gathers() as gathers:
        with StreamDataPipeline(iter(former_messages(n_msgs)), batch_size=8,
                                mesh=mesh, device="cpu") as pipe:
            for sb in pipe:
                drv.submit(sb)
        drv.finish()
    aot_losses = None
    if "expert" in axes:  # a state sharded over a model axis, captured
        aot = MeshTrainDriver.build(model(), mesh, device="cpu",
                                    loss_fn=former_loss, sync_every=1,
                                    inflight=1, aot=True, aot_batch=first)
        with StreamDataPipeline(iter(former_messages(n_msgs)), batch_size=8,
                                mesh=mesh, device="cpu") as pipe:
            for sb in pipe:
                aot.submit(sb)
        aot.finish()
        aot_losses = np.asarray(aot.losses)
    shards = drv.state.shards
    names = {id(p): n for n, p in drv.state.model.named_parameters()}
    return {"losses": np.asarray(drv.losses),
            "specs": {str(sh.spec) for sh in shards.specs if sh.sharded}
            if shards else set(),
            "expert_local": [tuple(s.shape) for p, s in zip(
                shards.params, shards.shards) if ".expert_" in names[id(p)]]
            if shards else [],
            "layout": drv.stats["layout"], "aot_losses": aot_losses,
            "local_first_loss": local_first, "aux": float(aux),
            "aux_router_grad": router_grad.numpy().T.copy(),
            "einsum_experts": sorted(set(experts)), "gathers": gathers[0],
            "tally": drv.collective_tally}


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


def _nested(leaves: dict, prefix: str) -> dict:
    """``{module: {leaf: array}}`` of the snapshot leaves under ``prefix``
    (``.params['Dense_0']['kernel']`` -> ``["Dense_0"]["kernel"]``)."""
    import re

    out: dict = {}
    for path, v in leaves.items():
        if path.startswith(prefix + "["):
            mod, leaf = re.findall(r"\['([^']*)'\]", path[len(prefix):])
            out.setdefault(mod, {})[leaf] = np.asarray(v)
    return out


def case_rl_mesh(params_np, prioritized=False, capacity=64, batch=16,
                 steps_per_insert=2, seed=0, axes=None, rules=None,
                 captured=False):
    """The mesh learner on a scripted insert sequence: rank 0 inserts (the
    actor rank), every rank agrees on the inserts before each compose,
    trains its rows of each draw and all-reduces the gradients; the
    losses, the final parameters, the priorities and the accounting.
    ``axes`` (default ``{"data": -1}``) and ``rules`` (``(pattern,
    spec)`` pairs) split the state over a model axis: then also the
    target's full values and this rank's shard shapes. ``captured``
    steps the learner through ``CapturedStep(step, mesh=mesh)`` (eager on
    gloo: its ``eager_calls`` are returned)."""
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

    from blendjax_torch.parallel import PartitionRule
    from blendjax_torch.weights import (
        load_train_state_leaves,
        train_state_leaves,
    )

    mesh = _mesh(axes or {"data": -1})
    res = TrajectoryReservoir(capacity, rng=seed, mesh=mesh, device="cpu",
                              prioritized=prioritized)
    model = QNetwork(hidden=(16,), n_actions=3)
    model.load_state_dict(policy_from_flax(params_np))
    rules = (None if rules is None
             else tuple(PartitionRule(p, tuple(s)) for p, s in rules))
    state = make_rl_train_state(model, device="cpu", mesh=mesh, rules=rules)
    step = make_dqn_step(res, gamma=0.98, **mesh_rl_step_kwargs(
        state, mesh, rules=rules))
    if captured:
        from blendjax_torch.train import CapturedStep

        step = CapturedStep(step, mesh=mesh)
    drv = RLTrainDriver(step, state, res, mesh=mesh, batch_size=batch,
                        min_fill=8, sync_every=1, inflight=1,
                        sample_timeout_s=30.0)
    for ins in rl_inserts():
        if dist.get_rank() == 0:
            res.insert(ins)
        for _ in range(steps_per_insert):
            drv.train_step()
    drv.drain()
    out = {"losses": np.asarray(drv.losses),
           "prio": res._priorities.numpy().copy(), "stats": res.stats,
           "ring_rows": int(res._buffers["obs"].shape[0]),
           "steps": drv.steps, "images": drv.images_retired,
           "sharded": state.shards is not None,
           "eager_calls": getattr(step, "eager_calls", None)}
    if state.shards is None:
        out.update(params=flax_tree(model), target=flax_tree(state.target))
        return out
    def host(tree):
        return {k: v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v) for k, v in tree.items()}

    leaves = host(train_state_leaves(state))
    # the snapshot round trip: a split state of other weights takes the
    # leaves into its shards (the target's too) and gives them back
    fresh = make_rl_train_state(QNetwork(hidden=(16,), n_actions=3),
                                device="cpu", mesh=mesh, rules=rules)
    load_train_state_leaves(fresh, leaves)
    again = host(train_state_leaves(fresh))
    out.update(params=_nested(leaves, ".params"),
               round_trip=set(again) == set(leaves) and all(
                   np.array_equal(leaves[k], v) for k, v in again.items()),
               target=_nested(leaves, ".target_params"),
               local=[tuple(t.shape) for t in state.shards.shards],
               target_local=[tuple(t.shape)
                             for t in state.target_shards.shards],
               full=[tuple(s) for s in state.shards.full_shapes])
    return out


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


# -- cases: captured steps on split states ----------------------------------------------------


def _split_tensors(state) -> list:
    """This rank's shards and every tensor of their optimizer's state, in
    a fixed order (read directly, not through the capture's own list)."""
    shards = state.shards.shards
    return list(shards) + [t for p in shards for _n, t in sorted(
        state.optimizer.state.get(p, {}).items())]


def case_mesh_aot(params_np, axes, layout=None, moe=False, n_msgs=4):
    """A StreamFormer (``FORMER_TP``; ``FORMER_MOE`` with ``moe``) through
    ``MeshTrainDriver.build(aot=True, aot_batch=...)`` on the mesh of
    ``axes`` (named ``layout`` when given) and through the same build
    without ``aot``, over the recorded messages: both runs' losses, what
    the aot build made, the first step call's collectives, the bytes a
    captured step would take as arguments (the state it updates in place
    and the batch), and whether ``_snapshot`` / ``_restore`` give a split
    state's shards back bit for bit after three updates."""
    import torch

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.parallel import state_resident_bytes
    from blendjax_torch.parallel.sharding import batch_sharding, local_rows
    from blendjax_torch.train import MeshTrainDriver
    from blendjax_torch.train.aot import _restore, _snapshot, _state_tensors
    from blendjax_torch.weights import streamformer_from_flax

    mesh = _mesh(axes)
    cfg = FORMER_MOE if moe else FORMER_TP
    first = {k: local_rows(torch.from_numpy(v), batch_sharding(mesh))
             for k, v in former_messages(1)[0].items()
             if k in ("image", "xy")}
    out = {}
    for aot in (False, True):
        model = StreamFormer(**cfg, dtype=torch.float32, attn_backend="xla",
                             image_shape=(32, 32))
        model.load_state_dict(streamformer_from_flax(params_np))
        drv = MeshTrainDriver.build(
            model, mesh, device="cpu", loss_fn=former_loss, layout=layout,
            aot=aot, aot_batch=first if aot else None, sync_every=1,
            inflight=1)
        # a pipeline takes its messages' stamps: each run its own copy
        with StreamDataPipeline(iter(former_messages(n_msgs)), batch_size=8,
                                mesh=mesh, device="cpu") as pipe:
            for sb in pipe:
                drv.submit(sb)
        drv.finish()
        out["aot" if aot else "eager"] = np.asarray(drv.losses)
    state, step = drv.state, drv.step
    out.update(
        step=type(step).__name__, signatures=len(step.signatures),
        fallbacks=step.aot_fallbacks, tally=drv.collective_tally,
        layout=drv.stats["layout"], sharded=state.shards is not None,
        resident=state_resident_bytes(state),
        # a graph's argument bytes: the state it updates in place (what a
        # capture snapshots) and its static batch
        argument_bytes=sum(t.numel() * t.element_size() for t in (
            *(t for _key, t in _state_tensors(state)), *first.values())))
    if state.shards is not None:
        before = [t.detach().clone() for t in _split_tensors(state)]
        snap, step0 = _snapshot(state), state.step
        for _ in range(3):
            step(state, first)
        moved = [not torch.equal(a, b)
                 for a, b in zip(before, _split_tensors(state))]
        _restore(state, snap)
        state.step = step0
        out["moved"] = sum(moved)
        out["restored"] = all(torch.equal(a, b) for a, b in zip(
            before, _split_tensors(state)))
    return out


def case_aot_cache(params_np, tmp, layouts):
    """``MeshTrainDriver.build(aot=True, aot_cache_dir=...)`` once per
    entry of ``layouts`` into one manifest of this rank's: each build's
    ``(layout, cache hits, cache misses)``."""
    import torch
    import torch.distributed as dist

    from blendjax_torch.models import StreamFormer
    from blendjax_torch.parallel import resolve_layout
    from blendjax_torch.parallel.sharding import batch_sharding, local_rows
    from blendjax_torch.train import MeshTrainDriver
    from blendjax_torch.weights import streamformer_from_flax

    cache = os.path.join(tmp, f"aot-cache-rank{dist.get_rank()}")
    out = []
    for layout in layouts:
        mesh = resolve_layout(layout).create_mesh(devices="cpu")
        model = StreamFormer(**FORMER_TP, dtype=torch.float32,
                             attn_backend="xla", image_shape=(32, 32))
        model.load_state_dict(streamformer_from_flax(params_np))
        first = {k: local_rows(torch.from_numpy(v), batch_sharding(mesh))
                 for k, v in former_messages(1)[0].items()
                 if k in ("image", "xy")}
        drv = MeshTrainDriver.build(
            model, mesh, layout=layout, device="cpu", loss_fn=former_loss,
            aot=True, aot_batch=first, aot_cache_dir=cache)
        out.append((layout, drv.step.cache_hits, drv.step.cache_misses))
    return out


# -- cases: the split of the work over model axes ---------------------------------------------


FORMER_TP = dict(patch=8, dim=32, depth=2, num_heads=4, num_outputs=16)


def case_tp(params_np, axes, n_msgs=4, cfg=None):
    """A StreamFormer through ``MeshTrainDriver.build`` on a mesh with a
    ``tp`` axis (``FORMER_TP``, or ``cfg``): its losses, each split
    kernel's shape on this rank beside its full shape, the parameter
    gathers during the steps, the first step call's collectives by kind
    and axis, and the resident bytes; or the build's refusal."""
    import torch

    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.models import StreamFormer
    from blendjax_torch.parallel import state_resident_bytes
    from blendjax_torch.train import MeshTrainDriver
    from blendjax_torch.weights import streamformer_from_flax

    mesh = _mesh(axes)
    cfg = dict(cfg or FORMER_TP)
    model = StreamFormer(**cfg, dtype=torch.float32, attn_backend="xla",
                         image_shape=(32, 32))
    if params_np is not None:
        model.load_state_dict(streamformer_from_flax(params_np))
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    try:
        drv = MeshTrainDriver.build(model, mesh, device="cpu",
                                    loss_fn=former_loss, sync_every=1,
                                    inflight=1)
    except ValueError as e:
        return {"refused": str(e)}
    with _param_gathers() as gathers:
        with StreamDataPipeline(iter(former_messages(n_msgs)), batch_size=8,
                                mesh=mesh, device="cpu") as pipe:
            for sb in pipe:
                drv.submit(sb)
        drv.finish()
    local = {n: tuple(p.shape) for n, p in drv.state.model.named_parameters()}
    return {"losses": np.asarray(drv.losses), "full": full, "local": local,
            "gathers": gathers[0], "tally": drv.collective_tally,
            "resident": state_resident_bytes(drv.state),
            "lead": int(sb["image"].shape[0]), "refused": None}


def case_tp_block(params_np, x, g, axes):
    """One StreamFormer ``Block`` (flax weights) with its attention and MLP
    kernels split over ``tp`` as ``ShardedParams`` splits them (this
    rank's block of each, the qkv bias on D): the output for the
    replicated input ``x`` and the input gradient of ``sum(out * g)``."""
    import torch

    from blendjax_torch.models import Block
    from blendjax_torch.parallel.sharding import Resident

    mesh = _mesh(axes)
    c = x.shape[-1]
    h = 4
    blk = Block(c, h, dtype=torch.float32, attn_backend="xla")
    a = params_np["MultiHeadAttention_0"]
    state = {
        "norm1.weight": params_np["LayerNorm_0"]["scale"],
        "norm1.bias": params_np["LayerNorm_0"]["bias"],
        "norm2.weight": params_np["LayerNorm_1"]["scale"],
        "norm2.bias": params_np["LayerNorm_1"]["bias"],
        "attn.qkv.weight": a["qkv"]["kernel"].reshape(c, -1).T,
        "attn.qkv.bias": a["qkv"]["bias"].reshape(-1),
        "attn.proj.weight": a["proj"]["kernel"].T,
        "attn.proj.bias": a["proj"]["bias"],
        "fc1.weight": params_np["Dense_0"]["kernel"].T,
        "fc1.bias": params_np["Dense_0"]["bias"],
        "fc2.weight": params_np["Dense_1"]["kernel"].T,
        "fc2.bias": params_np["Dense_1"]["bias"],
    }
    blk.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in state.items()})
    d = c // h
    splits = (  # module, name, layout, flax dim
        (blk.attn, "qkv.weight", ("general", (3, h, d)), 2),
        (blk.attn, "qkv.bias", ("reshape", (3, h, d)), 2),
        (blk.attn, "proj.weight", "dense", 0),
        (blk, "fc1.weight", "dense", 1),
        (blk, "fc2.weight", "dense", 0),
    )
    for mod, name, layout, dim in splits:
        p = mod.get_parameter(name)
        res = Resident(mesh, "tp", p.shape, layout, dim)
        mod.__dict__.setdefault("_bjx_splits", {})[name] = res
        p.data = res.local(p.data)
    xt = torch.from_numpy(x).requires_grad_()
    out = blk(xt)
    (out * torch.from_numpy(g)).sum().backward()
    return {"out": _np(out), "dx": _np(xt.grad),
            "qkv_local": tuple(blk.attn.qkv.weight.shape)}


def _stamped(n_batches=8, rows=8):
    """Scripted global batches of ``rows`` rows, each stamped with its
    scenario (two, alternating) in every row's ``_meta``."""
    out = []
    for i in range(n_batches):
        sid = "even" if i % 2 == 0 else "odd"
        out.append({
            "image": np.full((rows, 4, 4, 3), i, np.uint8),
            "_meta": [{"btid": 0, "_scenario": {"id": sid, "ver": 1}}
                      for _ in range(rows)]})
    return out


def stamped_echo_run(batches, mesh=None, capacity=32, factor=4, rng=3):
    """An ``EchoingPipeline(augment=None)`` over ``batches``, each yielded
    only once the draw loop waited for it (as the one-card parity test
    feeds both packages), on ``mesh`` (each rank its rows of every global
    batch) or one card; returns each draw's stamps, the scenario ledger's
    totals, (fresh, echoed, steps) and every slot's stamp."""
    import time

    import blendjax_torch.data.echo as mod
    from blendjax_torch.parallel.sharding import batch_sharding, local_rows
    from blendjax_torch.scenario import ScenarioAccounting

    led = ScenarioAccounting()
    orig, mod.scenario_accounting = mod.scenario_accounting, led
    ref = [None]
    sh = batch_sharding(mesh) if mesh is not None else None

    def paced():
        for i, b in enumerate(batches):
            if i:
                deadline = time.monotonic() + 60.0
                while ref[0].saturated_waits < i:
                    if time.monotonic() > deadline:
                        raise TimeoutError("the draw loop never waited")
                    time.sleep(0.002)
            if sh is not None:
                rows = local_rows(np.arange(len(b["_meta"])), sh)
                b = {"image": local_rows(b["image"], sh),
                     "_meta": [b["_meta"][j] for j in rows]}
            yield b

    try:
        pipe = mod.EchoingPipeline(
            paced(), augment=None, batch_size=len(batches[0]["_meta"]),
            rng=rng, capacity=capacity, max_echo_factor=factor,
            device="cpu", mesh=mesh)
        ref[0] = pipe
        rows = []
        with pipe:
            for b in pipe:
                rows.append(b.get("_scenario_rows"))
    finally:
        mod.scenario_accounting = orig
    return {"rows": rows, "totals": led.totals(),
            "counts": (pipe.fresh, pipe.echoed, pipe.steps),
            "slots": list(pipe._slot_scen)}


def case_echo_stamps():
    """Stamped batches into an echo ring sharded over every rank: the
    cross-rank stamps make the draws, the ledger and the slots the
    one-card run's (which this rank computes too)."""
    mesh = _mesh({"data": -1})
    return {"mesh": stamped_echo_run(_stamped(), mesh),
            "one": stamped_echo_run(_stamped())}


def _mixed_stamps(n_batches=8, rows=8):
    """Scripted global batches: every 4th stamped in all rows, every 4th
    (from the third) in its first half of rows only, the others
    unstamped."""
    out = []
    for i in range(n_batches):
        sid = {0: "all", 2: "half"}.get(i % 4)
        stamped = rows if i % 4 == 0 else (rows // 2 if sid else 0)
        out.append({
            "image": np.full((rows, 4, 4, 3), i, np.uint8),
            "_meta": [{"btid": 0, **({"_scenario": {"id": sid, "ver": 1}}
                                     if r < stamped else {})}
                      for r in range(rows)]})
    return out


def case_echo_stamp_gathers():
    """Batches stamped in all rows, in the first half of rows (some ranks'
    rows only) and not at all, into a ring sharded over every rank: the
    run is the one-card run's, and the ranks all-gather the stamps of
    the stamped inserts only."""
    from blendjax_torch.parallel.mesh import RankAgreement

    calls = [0]
    inner = RankAgreement.gather_objects

    def counted(self, obj):
        calls[0] += 1
        return inner(self, obj)

    RankAgreement.gather_objects = counted
    try:
        mesh_run = stamped_echo_run(_mixed_stamps(), _mesh({"data": -1}))
    finally:
        RankAgreement.gather_objects = inner
    return {"mesh": mesh_run, "one": stamped_echo_run(_mixed_stamps()),
            "gathers": calls[0]}


def case_echo_rows(n_draws=6):
    """Draws of a ring sharded over every rank with the default paired
    augmentation (flip and crop with the points, colour jitter): each
    draw's rows on this rank against its rows of the one-card draw of the
    same counter, and the rows each apply ran on."""
    import torch

    from blendjax_torch.data import SampleReservoir
    from blendjax_torch.data.echo import default_echo_augment
    from blendjax_torch.parallel import ring_sharding
    from blendjax_torch.parallel.sharding import local_rows

    mesh = _mesh({"data": -1})
    sh = ring_sharding(mesh)
    applied = []

    def reservoir(sharding):
        aug = default_echo_augment(points_key="xy")
        inner = aug._apply

        def spy(gens, batch, rows=None):
            if sharding is not None:
                applied.append(int(batch["image"].shape[0]))
            return inner(gens, batch, rows)

        aug._apply = spy
        return SampleReservoir(64, augment=aug, rng=7, sharding=sharding,
                               device="cpu")

    mine, one = reservoir(sh), reservoir(None)
    for hb in messages(4):
        fields = {"image": hb["image"], "xy": hb["xy"]}
        mine.insert({k: local_rows(v, sh) for k, v in fields.items()})
        one.insert(fields)
    idx_rng = np.random.default_rng(11)
    equal = []
    for _ in range(n_draws):
        idx = idx_rng.integers(0, 64, B)
        got, want = mine.sample(idx), one.sample(idx)
        equal.append(all(torch.equal(got[k], local_rows(want[k], sh))
                         for k in ("image", "xy")))
    return {"equal": equal, "applied": applied,
            "row_local": mine.augment.row_local}


# -- cases: captured mesh steps (sharded draws) ---------------------------------------

RING_CAPACITY = 16


def ring_fields(capacity=RING_CAPACITY, seed=4):
    """A whole ring of host arrays: float, uint8 image rows, int and bool
    fields (a bool sums as bytes)."""
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(capacity, 3, 5)).astype(np.float32),
            "image": rng.integers(0, 256, (capacity, 2, 3, 4), np.uint8),
            "action": rng.integers(-9, 9, capacity).astype(np.int32),
            "done": rng.random(capacity) < 0.5}


def ring_draws(capacity=RING_CAPACITY):
    """Draws of 8 global slots: random with repeats, one slot repeated, a
    draw inside the last quarter of the ring (held by one rank of a ring
    split 2 or 4 ways) and one inside the first half (missing every rank
    past it)."""
    rng = np.random.default_rng(8)
    q = capacity // 4
    return {"random": rng.integers(0, capacity, 8),
            "repeated": np.array([5, 5, 5, 2, 2, 9, 9, 5]),
            "one_rank": np.array([3, 0, 1, 1, 2, 3, 0, 2]) + 3 * q,
            "misses_ranks": rng.integers(0, 2 * q, 8)}


def case_ring_gather():
    """This rank's slice of :func:`ring_fields` over the batch axes of
    ``{"data": -1}``, and each of :func:`ring_draws` gathered from a
    device index tensor: every row on every rank (``ring_gather``) and
    this rank's rows (``make_ring_gather``), with the all-reduced bytes;
    then one gather with ``Tensor.numpy``, ``tolist``, ``cpu`` and
    ``item`` made to raise, which a host read of the indices would hit."""
    import torch

    from blendjax_torch.data.ring import (
        allocate_ring,
        make_ring_gather,
        ring_gather,
    )
    from blendjax_torch.parallel import ring_sharding
    from blendjax_torch.parallel.collectives import (
        collective_counts,
        tally_diff,
    )

    mesh = _mesh({"data": -1})
    sh = ring_sharding(mesh)
    bufs = allocate_ring(RING_CAPACITY, sharding=sh, device="cpu",
                         initial=ring_fields())
    gather = make_ring_gather(RING_CAPACITY, sh)
    out = {"local_rows": int(bufs["obs"].shape[0])}
    for name, idx in ring_draws().items():
        t = torch.from_numpy(idx)
        before = collective_counts()
        whole = ring_gather(bufs, t, sharding=sh, capacity=RING_CAPACITY)
        reduced = tally_diff(collective_counts(), before)["per_kind"]
        out[name] = {
            "whole": {k: v.numpy().copy() for k, v in whole.items()},
            "mine": {k: v.numpy().copy() for k, v in gather(bufs, t).items()},
            "reduced": reduced["all-reduce"]}
    idx = torch.from_numpy(ring_draws()["random"])

    def refuse(self, *args, **kwargs):
        raise RuntimeError("the draw's indices were read on the host")

    saved = {m: getattr(torch.Tensor, m)
             for m in ("numpy", "tolist", "cpu", "item")}
    try:
        for m in saved:
            setattr(torch.Tensor, m, refuse)
        gather(bufs, idx)
        out["host_read"] = None
    except RuntimeError as e:
        out["host_read"] = str(e)
    finally:
        for m, fn in saved.items():
            setattr(torch.Tensor, m, fn)
    return out


def case_echo_capture(params_np, n_inserts=4, draws=2):
    """The echo fused step over a ring sharded on ``{"data": -1}``
    through ``CapturedStep(make_mesh_echo_fused_step(...), mesh=mesh)``
    on scripted inserts (this rank's rows of :func:`messages`) and draws
    (the reservoir test's index stream): the losses, the wrapper's eager
    calls and graph replays, and the ring's rows on this rank."""
    from blendjax_torch.data import SampleReservoir
    from blendjax_torch.parallel import ring_sharding
    from blendjax_torch.parallel.sharding import local_rows
    from blendjax_torch.train import (
        CapturedStep,
        make_mesh_echo_fused_step,
        make_train_state,
    )

    mesh = _mesh({"data": -1})
    sh = ring_sharding(mesh)
    res = SampleReservoir(64, augment=None, rng=7, sharding=sh, device="cpu")
    state = make_train_state(_cube(params_np), device="cpu", mesh=mesh)
    step = CapturedStep(make_mesh_echo_fused_step(state, mesh, res),
                        mesh=mesh)
    idx_rng = np.random.default_rng(11)
    losses = []
    for hb in messages(n_inserts):
        res.insert({k: local_rows(hb[k], sh) for k in ("image", "xy")})
        for _ in range(draws):
            token = res.draw_token(idx_rng.integers(0, res.size, B))
            state, m = step(state, token)
            losses.append(float(m["loss"]))
    return {"losses": np.asarray(losses), "eager_calls": step.eager_calls,
            "replays": step.graph_replays, "steps": state.step,
            "ring_rows": int(res.device_buffers()["image"].shape[0])}


# -- cases: the datagen examples on a mesh -------------------------------------------


def f32_cube_regressor():
    """The port's ``CubeRegressor`` computing in f32, as the examples import
    it (the precision policy's default is bf16-compute), and TF32 off."""
    import torch

    import blendjax_torch.models as PM

    base = PM.CubeRegressor
    if getattr(base, "f32", False):
        return

    class PortF32(base):
        f32 = True

        def __init__(self, *a, **kw):
            kw.setdefault("dtype", torch.float32)
            super().__init__(*a, **kw)

    PM.CubeRegressor = PortF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def case_example(argv, relpath="datagen/train.py", f32=True):
    """``main(argv)`` of a port example on this rank's mesh (the group is
    open, so the example builds ``{"data": -1}`` over it): its printed
    text and the plain values of the dict it returns."""
    import contextlib
    import importlib.util
    import io

    import torch.distributed as dist

    from blendjax_torch.obs import lineage, tracer
    from blendjax_torch.scenario import accounting
    from blendjax_torch.utils.metrics import metrics

    for reg in (metrics, lineage, tracer, accounting):
        reg.reset()
    if f32:
        f32_cube_regressor()
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "blendjax_torch", "examples")
    spec = importlib.util.spec_from_file_location(
        "example_" + relpath.replace("/", "_")[:-3],
        os.path.join(root, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(list(argv) + ["--device", "cpu"]) or {}
    dist.barrier()
    keep = ("losses", "last_loss", "images", "seq_gaps", "checkpoint",
            "scenarios", "curriculum_weights", "fleet", "rank", "world")
    res = {k: out[k] for k in keep if k in out}
    drv = out.get("driver")
    if drv is not None:
        res["driver_losses"] = list(drv.losses)
        res["steps"] = drv.steps
    step = out.get("step")
    if step is not None:
        res["step_type"] = type(step).__name__
        res["eager_calls"] = getattr(step, "eager_calls", None)
    return {"text": buf.getvalue(), **res}


def case_example_capture(argv, relpath="datagen/train.py"):
    """An example's run on this rank's mesh as it is (its step wrapped in
    ``CapturedStep``) and again with ``CapturedStep`` the identity (the
    bare mesh step): the wrapped run's step type and eager calls, and
    both runs' losses."""
    import blendjax_torch.train as T

    wrapped = case_example(argv, relpath, f32=False)
    inner = T.CapturedStep
    T.CapturedStep = lambda step, mesh=None: step
    try:
        bare = case_example(argv, relpath, f32=False)
    finally:
        T.CapturedStep = inner
    return {"wrapped": wrapped, "bare": bare}


def _fast_fleet():
    """The example's fleet controller ticking every 0.5 s with a 1 s
    cooldown (a short run sees several ticks)."""
    import blendjax_torch.fleet as F

    if getattr(F.FleetController, "fast", False):
        return

    class FastController(F.FleetController):
        fast = True

        def __init__(self, *a, **kw):
            kw["interval_s"] = 0.5
            super().__init__(*a, **kw)

    class FastPolicy(F.FleetPolicy):
        def __init__(self, **kw):
            super().__init__(**{"cooldown_s": 1.0, **kw})

    F.FleetController, F.FleetPolicy = FastController, FastPolicy


def case_example_fleet(argv):
    _fast_fleet()
    return case_example(argv, f32=False)


class _BreachOnRankOne:
    """A stand-in for the example's ``StatsReporter``: on rank 1 its
    thread calls the snapshot-on-breach arm once, as a sustained SLO breach
    would; rank 0 sees no breach."""

    def __init__(self, *a, checkpoint_on_breach=None, **kw):
        self.arm = checkpoint_on_breach
        self.fleet = None
        self.healthy = True
        self.thread = None

    def health(self):
        return True

    def start(self):
        import threading

        import torch.distributed as dist

        if dist.get_rank() == 1 and self.arm is not None:
            self.thread = threading.Thread(target=self.arm, daemon=True)
            self.thread.start()
        return self

    def stop(self):
        if self.thread is not None:
            self.thread.join(10.0)


def case_example_breach(argv):
    """The example with a breach raised on rank 1 alone."""
    import blendjax_torch.obs as O

    real = O.StatsReporter
    O.StatsReporter = _BreachOnRankOne
    try:
        return case_example(argv)
    finally:
        O.StatsReporter = real


def case_checkpoint_flow(prefix, tmp, every=10, steps=30, resumed_steps=20):
    """The example over a looped recording of ``every`` global batches:
    an uninterrupted run of ``steps`` with snapshots every ``every`` steps,
    then a resume from the first snapshot (copied alone into a directory
    of its own) for ``resumed_steps``: the resumed run meets the batches
    the uninterrupted one met after that snapshot."""
    import shutil

    import torch.distributed as dist

    base = ["--batch", "8", "--shape", "32", "32", "--replay", prefix]
    full_dir = os.path.join(tmp, "ck-full")
    full = case_example(base + ["--steps", str(steps), "--checkpoint",
                                full_dir, "--checkpoint-every", str(every)])
    first = os.path.join(tmp, "ck-first")  # kept as it is, for others
    again = os.path.join(tmp, "ck-resumed")
    if dist.get_rank() == 0:
        name = f"step-{every:08d}"
        shutil.copytree(os.path.join(full_dir, name),
                        os.path.join(first, name))
        shutil.copytree(first, again)
    dist.barrier()
    resumed = case_example(base + ["--steps", str(resumed_steps),
                                   "--checkpoint", again, "--resume",
                                   "--checkpoint-every", "0"])
    return {"full": full, "resumed": resumed, "first": first}


def case_recorded_rows(prefix, n=4, chunk=1):
    """This rank's rows of the first ``n`` replayed batches of a
    recording (decoded)."""
    from blendjax_torch.data import StreamDataPipeline

    mesh = _mesh({"data": -1})
    rows = []
    with StreamDataPipeline.from_recording(
            prefix, batch_size=8, mesh=mesh, device="cpu",
            chunk=chunk) as pipe:
        for i, b in enumerate(pipe):
            rows.append({k: _np(b[k]) if k != "image" else
                         b[k].numpy().copy() for k in ("image", "xy")})
            if i + 1 == n:
                break
    return {"rows": rows, "rank_batch": pipe.rank_batch,
            "local": pipe.local_rows}


def case_replay_refusal(prefix):
    from blendjax_torch.data import StreamDataPipeline

    try:
        StreamDataPipeline.from_recording(prefix, batch_size=12,
                                          mesh=_mesh({"data": -1}),
                                          device="cpu")
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def case_agreed_requests(params_np, prefix, tmp):
    """``MeshTrainDriver(checkpoint=...)`` over a rank's own recording
    (its pipeline's agreement carries the requests): a snapshot requested
    on rank 1 alone after step 2, then a preemption (its guard's request)
    on rank 1 alone after step 5. Rank 0 alone writes."""
    import torch.distributed as dist

    from blendjax_torch.checkpoint import (
        PreemptionGuard,
        PreemptionRequested,
        SnapshotManager,
    )
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.train import MeshTrainDriver

    rank = dist.get_rank()
    mesh = _mesh({"data": -1})
    ckpt = os.path.join(tmp, "agreed")
    mgr = SnapshotManager(ckpt, read_only=rank != 0)
    drv = MeshTrainDriver.build(_cube(params_np), mesh, None, device="cpu",
                                sync_every=1, inflight=1, checkpoint=mgr,
                                checkpoint_every=0)
    guard = PreemptionGuard(drv, install=False)
    preempted = None
    with StreamDataPipeline.from_recording(
            prefix, batch_size=8, mesh=mesh, device="cpu", loop=True,
            requests=drv.requests) as pipe:
        try:
            for b in pipe:
                drv.submit(b)
                if rank == 1 and drv.steps == 2:
                    drv.request_checkpoint()
                if rank == 1 and drv.steps == 5:
                    guard.request()
                if drv.steps >= 12:
                    break
        except PreemptionRequested as e:
            preempted = (drv.steps, str(e))
    mgr.close()
    dist.barrier()
    return {"steps": mgr.steps(), "checkpoints": drv.checkpoints,
            "preempted": preempted, "carried": pipe.local_rows}


class _Launcher:
    """A launcher with the elastic surface the controller drives and no
    process behind it."""

    def __init__(self, n):
        self.active = list(range(n))
        self.next = n

    def active_indices(self):
        return list(self.active)

    def active_count(self):
        return len(self.active)

    def poll_processes(self):
        return {i: None for i in self.active}

    def add_instance(self, extra_args=None):
        i, self.next = self.next, self.next + 1
        self.active.append(i)
        return i, {"DATA": f"inproc://{os.getpid()}-{i}"}

    def retire_instance(self, i, drain=True):
        self.active.remove(i)
        return {"DATA": f"inproc://{os.getpid()}-{i}"}


def case_fleet_agreed(verdicts, clock_rates, interval=0.05):
    """Two ways of ticking ``FleetController(agreement=...)`` over a stub
    launcher: by hand, this rank's scripted verdicts (``verdicts[rank]``)
    one per tick on a clock of its own (``clock_rates[rank]`` seconds per
    tick); then its thread, stopped at a different moment on each rank."""
    import time as _time

    import torch.distributed as dist

    from blendjax_torch.fleet import FleetController, FleetPolicy
    from blendjax_torch.parallel.mesh import RankAgreement

    mesh = _mesh({"data": -1})
    rank = dist.get_rank()
    verdicts, clock_rate = verdicts[rank], clock_rates[rank]
    policy = FleetPolicy(min_instances=1, max_instances=3, up_after=2,
                         down_after=2, cooldown_s=1.5)
    ctrl = FleetController(_Launcher(1), policy=policy,
                           agreement=RankAgreement(mesh))
    actions = []
    for t, kind in enumerate(verdicts):
        d = ctrl.tick(verdict=kind, now=clock_rate * t)
        actions.append((d["verdict"], d["action"], d["instances"]))
    threaded = FleetController(_Launcher(1), policy=policy,
                               interval_s=interval,
                               diagnose=lambda: verdicts[0],
                               agreement=RankAgreement(mesh)).start()
    _time.sleep(0.3 + 0.2 * rank)
    threaded.stop()
    return {"actions": actions, "events": [
        (e["action"], e.get("instance")) for e in ctrl.scale_events()],
        "instances": ctrl.launcher.active_count(),
        "threaded_ticks": threaded.state()["ticks"],
        "threaded_instances": threaded.launcher.active_count()}


CASES = {
    "example": case_example,
    "example_capture": case_example_capture,
    "ring_gather": case_ring_gather,
    "echo_capture": case_echo_capture,
    "example_fleet": case_example_fleet,
    "example_breach": case_example_breach,
    "checkpoint_flow": case_checkpoint_flow,
    "recorded_rows": case_recorded_rows,
    "replay_refusal": case_replay_refusal,
    "agreed_requests": case_agreed_requests,
    "fleet_agreed": case_fleet_agreed,
    "live": case_live,
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
    "mesh_aot": case_mesh_aot,
    "aot_cache": case_aot_cache,
    "equivalence": case_equivalence,
    "tp": case_tp,
    "tp_block": case_tp_block,
    "echo_stamps": case_echo_stamps,
    "echo_stamp_gathers": case_echo_stamp_gathers,
    "echo_rows": case_echo_rows,
}
