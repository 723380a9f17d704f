"""Producer fleet launcher (copied from ``blendjax/launcher/launcher.py``).

A context manager that allocates one address per (named socket x
instance), derives per-instance seeds ``seed + i``, spawns each producer in
its own session with the handshake appended after ``--``
(:mod:`blendjax_torch.launcher.arguments`), polls liveness, and kills
everything on exit. :class:`ProcessLauncher` spawns any command template,
so headless Python producers (:class:`PythonProducerLauncher`) and Blender
(:class:`BlenderLauncher`) take one code path. ``respawn=True`` brings a
dead producer back; by default a dead producer is an error.

The fleet is elastic: :meth:`ProcessLauncher.add_instance`,
:meth:`~ProcessLauncher.retire_instance`,
:meth:`~ProcessLauncher.respawn_instance` and
:meth:`~ProcessLauncher.scale_to`, every change of membership under one
reentrant lock.
"""

from __future__ import annotations

import os
import shutil
import signal
import socket as pysocket
import subprocess
import sys
import tempfile
import threading
import time

from blendjax_torch.launcher.arguments import format_launch_args
from blendjax_torch.launcher.launch_info import LaunchInfo
from blendjax_torch.transport.shm import REGISTRY_ENV as SHM_REGISTRY_ENV
from blendjax_torch.transport.shm import reap_registry
from blendjax_torch.utils.ipaddr import get_primary_ip
from blendjax_torch.utils.logging import get_logger
from blendjax_torch.utils.tg import guard

# the read-only surface of the membership tables, left unguarded: callers
# read a quiesced fleet from any thread; every mutation takes `_lock`
_MEMBER_READS = (
    "__getitem__", "__iter__", "__len__", "__contains__",
    "index", "count", "copy",
)

logger = get_logger("launcher")

# Every producer this process spawned (Popen objects; exited ones stay
# harmlessly). The emergency teardown of a caller that abandons a stuck
# session without running the context managers' exits: spawns from
# worker threads carry no parent-death signal and would outlive it.
_ALL_SPAWNED: list = []


def kill_all_spawned() -> None:
    """SIGKILL every spawned producer still running, by process group
    (each spawn starts its own session). Sweeps until the list stops
    growing, so a producer spawned by another thread mid-sweep is caught
    too."""
    swept = 0
    while True:
        snapshot = list(_ALL_SPAWNED)
        if len(snapshot) <= swept:
            return
        for proc in snapshot[swept:]:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
        swept = len(snapshot)


# Orphan-proofing (Linux only, prctl(2)) through an exec shim: a fresh
# single-threaded python sets PR_SET_PDEATHSIG on itself and execs the
# producer in place (same PID). Never through preexec_fn, which is
# fork-unsafe in a parent with threads (CUDA and zmq threads are live).
# The shim checks its parent again after arming: a launcher that died
# before the prctl leaves the shim reparented, and it exits instead of
# exec'ing an orphan. A failing prctl launches without the protection.
_PDEATHSIG_SHIM = """\
import os, sys
try:
    import ctypes
    ctypes.CDLL(None).prctl(1, 15)  # PR_SET_PDEATHSIG, SIGTERM
    if os.getppid() != int(sys.argv[1]):
        sys.exit(143)
except Exception:
    pass
os.execvp(sys.argv[2], sys.argv[2:])
"""


def _free_port(host: str) -> int:
    """A free TCP port, probed by binding port 0 (racy between probe and
    the producer's bind: :meth:`ProcessLauncher.add_instance` retries)."""
    with pysocket.socket(pysocket.AF_INET, pysocket.SOCK_STREAM) as s:
        s.setsockopt(pysocket.SOL_SOCKET, pysocket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


# bjx: thread-shared (the fleet controller's control thread scales the
# membership while the owner polls/retires: `_lock` guards it — BJX117)
class ProcessLauncher:
    """Launch ``num_instances`` producer processes speaking the handshake.

    ``command`` is a callable ``(instance_index, handshake_argv) ->
    list[str]`` giving the full argv of one instance. ``named_sockets``
    get one address per instance (``proto="ipc"``: unix sockets in a
    temporary directory; else ``tcp`` on ``bind_addr``, from
    ``start_port`` on or probed free); ``seed`` gives instance ``i`` the
    seed ``seed + i``; ``instance_args`` appends per-instance user flags;
    ``bind_addr='primaryip'`` exposes the producers to other machines.
    ``respawn=True`` relaunches a dead instance at the next :meth:`poll`
    (and so at :meth:`assert_alive`). A spawn that dies within
    ``bind_grace_s`` counts as a bind race in :meth:`add_instance`.

    Retired slots stay in place, so instance indices (the btids) stay
    stable for the consumer's lineage and for respawns.
    """

    #: add_instance retries with fresh addresses when the producer dies
    #: within the bind grace window (the probed port was taken first)
    BIND_RETRIES = 3

    def __init__(
        self,
        command,
        num_instances: int = 1,
        named_sockets=("DATA",),
        seed: int = 0,
        bind_addr: str = "127.0.0.1",
        start_port: int | None = None,
        instance_args=None,
        respawn: bool = False,
        proto: str = "tcp",
        bind_grace_s: float = 2.0,
    ):
        if num_instances <= 0:
            raise ValueError("need at least one instance")
        self.command = command
        self.num_instances = num_instances
        self.named_sockets = list(named_sockets)
        self.seed = seed
        self.instance_args = instance_args or [[] for _ in range(num_instances)]
        if len(self.instance_args) != num_instances:
            raise ValueError(
                f"{len(self.instance_args)} instance_args for "
                f"{num_instances} instances"
            )
        self.respawn = respawn
        self.proto = proto
        self.bind_addr = (
            get_primary_ip() if bind_addr == "primaryip" else bind_addr
        )
        self.start_port = start_port
        self.bind_grace_s = float(bind_grace_s)
        self._lock = threading.RLock()
        self.processes: list = guard(
            [], name="launcher.processes", lock=self._lock,
            exempt=_MEMBER_READS,
        )
        self.launch_info: LaunchInfo | None = None
        self._argvs: list = []
        self._ipc_dir: str | None = None
        self._shm_registry: str | None = None
        self._retired: set = guard(
            set(), name="launcher.retired", lock=self._lock,
            exempt=_MEMBER_READS,
        )
        self._next_port: int | None = None

    # -- address plan -------------------------------------------------------

    def _allocate_addresses(self) -> dict:
        """One address per (socket name x instance): ``{name: [addr, ...]}``,
        socket-major (with ``start_port``, ports ``start_port + k``)."""
        if self.proto == "ipc":
            base = self._ipc_dir = tempfile.mkdtemp(prefix="blendjax-ipc-")
            return {
                name: [
                    f"ipc://{base}/{name}-{i}"
                    for i in range(self.num_instances)
                ]
                for name in self.named_sockets
            }
        addresses: dict = {}
        port = self.start_port
        for name in self.named_sockets:
            addrs = []
            for _ in range(self.num_instances):
                if port is not None:
                    p, port = port, port + 1
                else:
                    p = _free_port(self.bind_addr)
                addrs.append(f"{self.proto}://{self.bind_addr}:{p}")
            addresses[name] = addrs
        self._next_port = port  # add_instance continues the ladder
        return addresses

    def _instance_addresses(self, index: int) -> dict:
        """A fresh ``{name: addr}`` for one new instance."""
        if self.proto == "ipc":
            if self._ipc_dir is None:
                raise RuntimeError("not launched")
            return {
                name: f"ipc://{self._ipc_dir}/{name}-{index}"
                for name in self.named_sockets
            }
        sockets = {}
        for name in self.named_sockets:
            if self._next_port is not None:
                p, self._next_port = self._next_port, self._next_port + 1
            else:
                p = _free_port(self.bind_addr)
            sockets[name] = f"{self.proto}://{self.bind_addr}:{p}"
        return sockets

    # -- lifecycle ----------------------------------------------------------

    def _instance_argv(self, i: int, sockets: dict, extra=None) -> list:
        handshake = ["--"] + format_launch_args(
            btid=i,
            btseed=self.seed + i,
            btsockets=sockets,
            extra=self.instance_args[i] if extra is None else extra,
        )
        return self.command(i, handshake)

    def __enter__(self) -> "ProcessLauncher":
        # under the membership lock: an observer sees the fleet before or
        # after the launch, never half-built
        with self._lock:
            addresses = self._allocate_addresses()
            self._argvs = []
            try:
                for i in range(self.num_instances):
                    sockets = {n: addresses[n][i] for n in self.named_sockets}
                    argv = self._instance_argv(i, sockets)
                    self._argvs.append(argv)
                    self.processes.append(self._spawn(argv))
                    logger.info(
                        "launched instance %d: %s", i, " ".join(map(str, argv))
                    )
            except BaseException:
                # __exit__ never runs when __enter__ raises: reap what was
                # spawned, then propagate
                self.__exit__(None, None, None)
                raise
            self.launch_info = LaunchInfo(
                addresses=addresses,
                commands=[" ".join(map(str, a)) for a in self._argvs],
                processes=[p.pid for p in self.processes],
            )
            return self

    def _spawn(self, argv):
        # A session of its own, so the producer's whole tree is signalled
        # together. The root that holds blendjax_torch goes first on the
        # child's PYTHONPATH: a producer script runs as a file, with its
        # own directory as sys.path[0].
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        parts = [pkg_root] + [
            p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p
        ]
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))

        # The launcher owns the unlink of the shared-memory rings of the
        # instances it spawned: their producers register each ring (a
        # marker file) in this directory; retire_instance and respawn reap
        # an instance's rings, __exit__ the rest, so a ring is unlinked
        # exactly once even when its producer is SIGKILLed.
        if self._shm_registry is None:
            self._shm_registry = tempfile.mkdtemp(prefix="blendjax-shm-")
        env[SHM_REGISTRY_ENV] = self._shm_registry

        # Orphan-proofing: the shim execs the real argv in place, so the
        # Popen's pid is the producer's. The parent-death signal fires
        # when the spawning THREAD dies (prctl(2)), so only main-thread
        # spawns take it: a producer respawned from a pipeline's ingest
        # thread must outlive that thread, and is reaped by __exit__.
        if (
            sys.platform == "linux"
            and threading.current_thread() is threading.main_thread()
        ):
            # the shim's Popen always succeeds; keep the FileNotFoundError
            # of a bad command by resolving it against the child's PATH
            exe = str(argv[0])
            if shutil.which(exe, path=env.get("PATH", os.defpath)) is None:
                raise FileNotFoundError(
                    f"producer command not found or not executable: {exe!r}"
                )
            # -S -E: the shim imports only os, sys and ctypes; skipping
            # site shrinks the window before the prctl arms
            argv = [
                sys.executable, "-S", "-E", "-c", _PDEATHSIG_SHIM,
                str(os.getpid()), *map(str, argv),
            ]
        proc = subprocess.Popen(argv, start_new_session=True, env=env)
        _ALL_SPAWNED.append(proc)
        return proc

    @property
    def addresses(self) -> dict:
        with self._lock:
            if self.launch_info is None:
                raise RuntimeError("not launched")
            return self.launch_info.addresses

    def poll(self) -> list:
        """Per-instance exit codes (None: running). With ``respawn=True``
        dead instances that are not retired are relaunched first."""
        with self._lock:
            codes = [p.poll() for p in self.processes]
            if self.respawn:
                for i, code in enumerate(codes):
                    if code is not None and i not in self._retired:
                        logger.warning(
                            "instance %d exited with %s; respawning", i, code
                        )
                        self.respawn_instance(i)
                        codes[i] = None
            return codes

    def poll_processes(self) -> list:
        """Per-instance exit codes, with no respawn."""
        with self._lock:
            return [p.poll() for p in self.processes]

    def assert_alive(self) -> None:
        """Raise ``RuntimeError`` if an instance that is not retired died
        (after the respawns of ``respawn=True``)."""
        with self._lock:
            if not self.processes:
                return
            codes = self.poll()
            dead = {
                i: c for i, c in enumerate(codes)
                if c is not None and i not in self._retired
            }
        if dead:
            raise RuntimeError(f"producer instances died (id: exitcode) {dead}")

    def wait(self) -> list:
        """Block until every instance exits; returns the exit codes. The
        waits run outside the lock, so the membership stays available."""
        with self._lock:
            procs = list(self.processes)
        return [p.wait() for p in procs]

    # -- elastic membership --------------------------------------------------

    @property
    def retired(self) -> frozenset:
        with self._lock:
            return frozenset(self._retired)

    def active_indices(self) -> list:
        """Indices of the instances in the fleet (not retired); a dead
        instance counts: it is respawn material, not a departure."""
        with self._lock:
            return [
                i for i in range(len(self.processes))
                if i not in self._retired
            ]

    def active_count(self) -> int:
        return len(self.active_indices())

    def instance_sockets(self, i: int) -> dict:
        """``{socket_name: addr}`` of one instance."""
        with self._lock:
            if self.launch_info is None:
                raise RuntimeError("not launched")
            return {
                n: self.launch_info.addresses[n][i] for n in self.named_sockets
            }

    def _watch_bind(self, proc, grace_s: float):
        """The exit code of a fresh spawn that died within ``grace_s``,
        else None."""
        deadline = time.monotonic() + max(0.0, grace_s)
        while True:
            code = proc.poll()
            if code is not None:
                return code
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.05)

    def add_instance(self, extra_args=None, bind_grace_s: float | None = None):
        """Grow the fleet by one instance; returns ``(index, sockets)``.

        The instance takes the next btid and seed and a fresh address per
        named socket. ``extra_args=None`` inherits the args of the highest
        active instance (a scale-up matches the running fleet's shapes);
        ``[]`` gives a bare instance. A tcp spawn on probed ports that dies
        within the bind grace window is retried up to ``BIND_RETRIES``
        times with new ports; with ``start_port`` or ipc an early death is
        a producer failure.
        """
        with self._lock:
            if self.launch_info is None:
                raise RuntimeError("not launched")
            i = self.num_instances
            grace = self.bind_grace_s if bind_grace_s is None else bind_grace_s
            if extra_args is None:
                active = self.active_indices()
                extra_args = self.instance_args[active[-1]] if active else []
            args = [str(a) for a in extra_args]
            reprobe = self.start_port is None and self.proto != "ipc"
            attempts = (self.BIND_RETRIES + 1) if reprobe else 1
            last_code = None
            for attempt in range(attempts):
                sockets = self._instance_addresses(i)
                argv = self._instance_argv(i, sockets, extra=args)
                proc = self._spawn(argv)
                code = self._watch_bind(proc, grace)
                if code is None:
                    self.num_instances += 1
                    self.instance_args.append(args)
                    self._argvs.append(argv)
                    self.processes.append(proc)
                    for name in self.named_sockets:
                        self.launch_info.addresses[name].append(sockets[name])
                    self.launch_info.commands.append(
                        " ".join(map(str, argv))
                    )
                    self.launch_info.processes.append(proc.pid)
                    logger.info(
                        "added instance %d (attempt %d): %s",
                        i, attempt + 1, " ".join(map(str, argv)),
                    )
                    return i, sockets
                last_code = code
                if attempt + 1 < attempts:
                    logger.warning(
                        "instance %d died with %s within %.1fs of launch "
                        "(probed port likely taken before bind); retrying "
                        "with fresh addresses", i, code, grace,
                    )
            raise RuntimeError(
                f"instance {i} failed to come up "
                f"({attempts} attempt(s), last exit code {last_code})"
            )

    def retire_instance(self, i: int, drain: bool = True,
                        timeout: float = 5.0) -> dict:
        """Remove instance ``i`` from the fleet; returns its sockets.

        ``drain=True`` sends SIGTERM to its process group and waits up to
        ``timeout`` for a clean exit (a producer that flushes on TERM
        delivers its tail) before the SIGKILL; ``drain=False`` kills at
        once. The slot stays; ``poll``, ``assert_alive`` and respawns skip
        it from now on, and its shared-memory rings are reaped.
        """
        with self._lock:
            if not (0 <= i < len(self.processes)):
                raise IndexError(f"no instance {i}")
            if i in self._retired:
                return self.instance_sockets(i)
            self._retired.add(i)
            proc = self.processes[i]
            sockets = self.instance_sockets(i)
            shm_registry = self._shm_registry
        if proc.poll() is None:
            if drain:
                _signal_group(proc, signal.SIGTERM)
                try:
                    proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    logger.warning(
                        "instance %d did not drain within %.1fs; killing",
                        i, timeout,
                    )
            if proc.poll() is None:
                _signal_group(proc, signal.SIGKILL)
                try:
                    proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    pass
        # reaped only once the process is gone, so a drain's descriptors
        # in flight stayed readable
        if shm_registry is not None:
            reap_registry(shm_registry, btid=i)
        logger.info("retired instance %d (%s)", i, sockets)
        return sockets

    def respawn_instance(self, i: int):
        """Relaunch a dead instance in place: the same argv and btid, so
        the consumer's lineage reads its fresh numbering as a restart."""
        with self._lock:
            if i in self._retired:
                raise ValueError(f"instance {i} is retired")
            if self.processes[i].poll() is None:
                return self.processes[i]
            # the dead producer's rings are unreadable from now on (the
            # new one makes its own): reap them
            if self._shm_registry is not None:
                reap_registry(self._shm_registry, btid=i)
            proc = self._spawn(self._argvs[i])
            self.processes[i] = proc
            self.launch_info.processes[i] = proc.pid
            logger.warning("respawned instance %d (pid %d)", i, proc.pid)
            return proc

    def scale_to(self, n: int, extra_args=None):
        """Grow or shrink the active fleet to ``n`` instances; returns
        ``(added, removed)`` as lists of ``(index, sockets)``. A shrink
        retires the highest active indices, draining each. Blocks on
        process lifecycles: call it from a control thread."""
        if n < 0:
            raise ValueError(f"cannot scale to {n} instances")
        added, removed = [], []
        with self._lock:
            while self.active_count() < n:
                added.append(self.add_instance(extra_args=extra_args))
            while self.active_count() > n:
                victim = self.active_indices()[-1]
                removed.append(
                    (victim, self.retire_instance(victim, drain=True))
                )
        return added, removed

    def __exit__(self, exc_type=None, exc=None, tb=None) -> bool:
        # teardown holds the membership for its bounded duration (every
        # wait below has a timeout)
        with self._lock:
            return self._exit_locked(exc_type)

    def _exit_locked(self, exc_type) -> bool:
        for p in self.processes:
            if p.poll() is None:
                _signal_group(p, signal.SIGTERM)
        for p in self.processes:
            try:
                p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                _signal_group(p, signal.SIGKILL)
                try:
                    p.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass  # unkillable: reported below
        still = [p.pid for p in self.processes if p.poll() is None]
        self.processes = guard(
            [], name="launcher.processes", lock=self._lock,
            exempt=_MEMBER_READS,
        )
        self._retired = guard(
            set(), name="launcher.retired", lock=self._lock,
            exempt=_MEMBER_READS,
        )
        if self._ipc_dir is not None:
            # SIGTERM'd producers never unlink their unix sockets
            shutil.rmtree(self._ipc_dir, ignore_errors=True)
            self._ipc_dir = None
        if self._shm_registry is not None:
            # every child is gone: unlink the rings still registered, then
            # the registry itself
            reap_registry(self._shm_registry)
            shutil.rmtree(self._shm_registry, ignore_errors=True)
            self._shm_registry = None
        if still:
            # never mask an exception in flight with the leak report
            if exc_type is None:
                raise RuntimeError(
                    f"producers still alive after teardown: {still}"
                )
            logger.error("producers still alive after teardown: %s", still)
        else:
            logger.info("all producer instances terminated")
        return False


def _signal_group(proc, sig) -> None:
    """Send ``sig`` to the process group of ``proc`` (its own session)."""
    try:
        os.killpg(os.getpgid(proc.pid), sig)
    except (ProcessLookupError, PermissionError):
        pass


class PythonProducerLauncher(ProcessLauncher):
    """Launch headless Python producers: ``python script [script_args] --
    handshake``, the script run as a file."""

    def __init__(self, script: str, script_args=None, **kwargs):
        self.script = script
        self.script_args = [str(a) for a in (script_args or [])]
        super().__init__(command=self._build, **kwargs)

    def _build(self, index, handshake):
        return [sys.executable, self.script, *self.script_args, *handshake]


class BlenderLauncher(ProcessLauncher):
    """Launch Blender instances running a scene and a producer script:
    ``blender <scene> [--background] --python-use-system-env --python
    <script> -- <handshake>``, so the JAX package's ``*.blend.py`` scripts
    and the port's run unchanged."""

    def __init__(
        self,
        scene: str = "",
        script: str = "",
        background: bool = False,
        blend_path=None,
        **kwargs,
    ):
        from blendjax_torch.launcher.finder import discover_blender

        self.blender_info = discover_blender(blend_path)
        if self.blender_info is None:
            raise FileNotFoundError(
                "no usable Blender found; install Blender and its producer "
                "dependencies, or use PythonProducerLauncher for headless "
                "producers"
            )
        self.scene = str(scene)
        self.script = str(script)
        self.background = background
        super().__init__(command=self._build, **kwargs)

    def _build(self, index, handshake):
        argv = [self.blender_info["path"]]
        if self.scene:
            argv.append(self.scene)
        if self.background:
            argv.append("--background")
        argv += ["--python-use-system-env", "--python", self.script]
        return argv + handshake
