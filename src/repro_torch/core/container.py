"""mini-docker — firmware-level container environment.

Implements the paper's 11 essential Docker commands (of 106): image
management (pull, rmi), container life cycle (create, run, start, stop,
restart, kill, rm) and monitoring (logs, ps).  Images are blobs +
manifests stored in λFS's private-NS under ``/images/``; a container's
rootfs is an overlay of read-only image layers (*lower*) and a writable
*upper* directory, mounted at ``/containers/<id>/rootfs``; stdout and
stderr are logged to ``/containers/<id>/rootfs/log``.

The "application" inside an image is a registered Python callable (the
workload kernel — e.g. the DLRM embed loop or a decode-serving loop),
executed with the container's namespace-isolated FS view and a
cgroup-style memory budget.

The port's copy of ``repro.core.container``.  ``to_jsonable`` takes
numpy only: apps hand back ``tensor.cpu().numpy()``, so the wire bytes
are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import io
import json
import time
import urllib.parse
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.lambda_fs import PRIVATE_NS, SHARABLE_NS, LambdaFS

MINI_DOCKER_COMMANDS = ["pull", "rmi", "create", "run", "start", "stop",
                        "restart", "kill", "rm", "logs", "ps"]

# global registry of containerized applications (entry-point callables)
APP_REGISTRY: Dict[str, Callable] = {}


def register_app(name: str):
    def deco(fn):
        APP_REGISTRY[name] = fn
        return fn
    return deco


class ContainerError(Exception):
    pass


class ContainerOOM(ContainerError, MemoryError):
    """A running app allocated past its cgroup-style ``mem_budget``.

    Subclasses both ContainerError (the container API contract: budget
    violations are container failures, the container transitions to
    ``dead``) and MemoryError (the POSIX-shaped signal an OOM-killed
    workload sees)."""


def to_jsonable(obj):
    """JSON-encode app results losslessly: ndarrays become tagged hex
    blobs (bit-exact across the wire — floats never round-trip through
    decimal), containers recurse, scalars pass through."""
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": obj.tobytes().hex(),
                "shape": list(obj.shape), "dtype": str(obj.dtype)}
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    return obj


def from_jsonable(obj):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            return np.frombuffer(
                bytes.fromhex(obj["__ndarray__"]), obj["dtype"]
            ).reshape(obj["shape"]).copy()
        return {k: from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [from_jsonable(x) for x in obj]
    return obj


def parse_query(query: str) -> Dict[str, str]:
    """docker-cli query-string parsing, ``parse_qsl`` style: valueless
    keys (``?detach``) map to ``""`` and values keep embedded ``=``
    (``?job=a=b``) instead of crashing ``dict(kv.split("="))``."""
    args: Dict[str, str] = {}
    for kv in query.split("&"):
        if not kv:
            continue
        k, _, v = kv.partition("=")
        args[urllib.parse.unquote_plus(k)] = urllib.parse.unquote_plus(v)
    return args


@dataclasses.dataclass
class ImageManifest:
    name: str
    entry: str                       # app registry key
    layers: List[str]
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @staticmethod
    def from_json(data: bytes) -> "ImageManifest":
        return ImageManifest(**json.loads(data))


def make_blob(manifest: ImageManifest, layer_data: Dict[str, bytes]) -> bytes:
    """A docker blob: compressed manifest + layers."""
    body = json.dumps({
        "manifest": json.loads(manifest.to_json()),
        "layers": {k: v.hex() for k, v in layer_data.items()},
    }).encode()
    return zlib.compress(body)


@dataclasses.dataclass
class ISPContainer:
    cid: str
    image: str
    entry: str
    state: str = "created"           # created|running|exited|dead
    exit_code: Optional[int] = None
    mem_budget: int = 1 << 30        # cgroup-style budget
    mem_used: int = 0
    created_at: float = 0.0


class MiniDocker:
    """Runs inside Virtual-FW; speaks docker-cli's HTTP dialect."""

    def __init__(self, fw, fs: LambdaFS, extents=None):
        self.fw = fw
        self.fs = fs
        self.extents = extents          # core.extent_store.ExtentStore
        self._containers: Dict[str, ISPContainer] = {}
        self._next_id = 0
        fs.mkdir("/images/blobs", PRIVATE_NS)
        fs.mkdir("/images/manifest", PRIVATE_NS)
        fs.mkdir("/containers", PRIVATE_NS)

    # -- HTTP REST front door (docker-cli compatible shape) --------------------

    def handle_http(self, request: str, body: bytes = b"") -> bytes:
        """e.g. 'POST /images/create?fromImage=embed' (blob in ``body``),
        'POST /containers/3/start?job=<json>' or 'GET /containers/3/logs'.

        Malformed requests return a 400-shaped JSON error instead of
        raising into the Ether-oN handler."""
        try:
            method, rest = request.split(" ", 1)
            path, _, query = rest.partition("?")
            args = parse_query(query)
            return self._route(method, path, args, body)
        except ContainerError as e:
            return json.dumps({"error": str(e), "status": 400}).encode()
        except Exception as e:      # malformed request, bad args, app error
            return json.dumps({"error": f"{type(e).__name__}: {e}",
                               "status": 400}).encode()

    def _route(self, method: str, path: str, args: Dict[str, str],
               body: bytes) -> bytes:
        def reply(obj) -> bytes:
            return obj if isinstance(obj, bytes) \
                else json.dumps(to_jsonable(obj)).encode()

        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ContainerError(f"bad path {path}")
        if parts[0] == "images":
            if parts[-1] == "json":
                return reply(self.images())
            if path == "/images/create":
                name = args.get("fromImage", "")
                if not name or not body:
                    raise ContainerError(
                        "pull needs ?fromImage=<name> and the blob as the "
                        "request body")
                return reply({"status": "pulled",
                              "name": self.cmd_pull(name, body).name})
            raise ContainerError(f"bad path {path}")
        if parts[0] != "containers":
            raise ContainerError(f"bad path {path}")
        if parts[-1] == "json":
            return reply(self.cmd_ps())
        if path == "/containers/create":
            return reply({"Id": self.cmd_create(
                args["image"], mem_budget=int(args.get("mem", 1 << 30)))})
        if path == "/containers/run":
            cid, out = self.cmd_run(args["image"], **self._start_kwargs(args))
            return reply({"Id": cid, "result": out})
        cid = parts[1]
        action = parts[2] if len(parts) > 2 else ""
        if method == "DELETE" or action == "rm":
            self.cmd_rm(cid)
            return reply({"status": "removed"})
        if action == "start":
            return reply({"result": self.cmd_start(
                cid, **self._start_kwargs(args))})
        if action == "restart":
            return reply({"result": self.cmd_restart(
                cid, **self._start_kwargs(args))})
        fn = {"stop": self.cmd_stop, "kill": self.cmd_kill,
              "logs": self.cmd_logs}.get(action)
        if fn is None:
            raise ContainerError(f"bad action {action!r}")
        return reply(fn(cid))

    @staticmethod
    def _start_kwargs(args: Dict[str, str]) -> Dict[str, Any]:
        """Query args an app start accepts: ``job=<json>`` carries an
        analytics program list (the docker-cli front door for the
        in-storage analytics path)."""
        kw: Dict[str, Any] = {}
        if args.get("job"):
            jobs = json.loads(args["job"])
            kw["jobs"] = jobs if isinstance(jobs, list) else [jobs]
        return kw

    # -- image management -------------------------------------------------------

    def cmd_pull(self, name: str, blob: bytes) -> ImageManifest:
        """1. retrieve blob -> 2. unpack per image spec -> store in λFS."""
        self.fs.write(f"/images/blobs/{name}", blob, PRIVATE_NS)
        body = json.loads(zlib.decompress(blob))
        manifest = ImageManifest(**body["manifest"])
        self.fs.write(f"/images/manifest/{name}", manifest.to_json(),
                      PRIVATE_NS)
        for lname, hexdata in body["layers"].items():
            self.fs.write(f"/images/layers/{name}/{lname}",
                          bytes.fromhex(hexdata), PRIVATE_NS)
        return manifest

    def cmd_rmi(self, name: str):
        self.fs.unlink(f"/images/blobs/{name}", PRIVATE_NS)
        self.fs.unlink(f"/images/manifest/{name}", PRIVATE_NS)
        for layer in self.fs.listdir(f"/images/layers/{name}", PRIVATE_NS):
            self.fs.unlink(f"/images/layers/{name}/{layer}", PRIVATE_NS)

    def images(self) -> List[str]:
        return self.fs.listdir("/images/manifest", PRIVATE_NS)

    # -- container life cycle ----------------------------------------------------

    def cmd_create(self, image: str, mem_budget: int = 1 << 30) -> str:
        if not self.fs.exists(f"/images/manifest/{image}", PRIVATE_NS):
            raise ContainerError(f"image {image} not pulled")
        manifest = ImageManifest.from_json(
            self.fs.read(f"/images/manifest/{image}", PRIVATE_NS))
        self._next_id += 1
        cid = str(self._next_id)
        # rootfs = read-only lower (image layers) + writable upper, merged
        root = f"/containers/{cid}/rootfs"
        self.fs.mkdir(root, PRIVATE_NS)
        self.fs.mkdir(f"/containers/{cid}/upper", PRIVATE_NS)
        for layer in manifest.layers:
            self.fs.symlink(f"/images/layers/{image}/{layer}",
                            f"{root}/{layer}", PRIVATE_NS)
        self.fs.write(f"{root}/log", b"", PRIVATE_NS)
        self._containers[cid] = ISPContainer(
            cid=cid, image=image, entry=manifest.entry,
            mem_budget=mem_budget, created_at=time.monotonic())
        return cid

    def cmd_start(self, cid: str, *args, **kw) -> Any:
        c = self._container(cid)
        if c.state == "running":
            raise ContainerError(f"{cid} already running")
        app = APP_REGISTRY.get(c.entry)
        if app is None:
            raise ContainerError(f"entry {c.entry} not registered")
        c.state = "running"
        self._log(cid, f"start entry={c.entry}\n")
        try:
            ctx = ContainerContext(self, c)
            result = app(ctx, *args, **kw)
            c.state = "exited"
            c.exit_code = 0
            self._log(cid, "exit code=0\n")
            return result
        except MemoryError as e:
            # ContainerOOM lands here too (it is-a MemoryError): budget
            # violations kill the container, docker-style exit 137
            c.state = "dead"
            c.exit_code = 137
            self._log(cid, f"OOM-killed: {e}\n")
            raise
        except Exception as e:  # stderr -> log
            c.state = "exited"
            c.exit_code = 1
            self._log(cid, f"stderr: {type(e).__name__}: {e}\n")
            raise

    def cmd_run(self, image: str, *args, **kw):
        cid = self.cmd_create(image)
        return cid, self.cmd_start(cid, *args, **kw)

    def cmd_stop(self, cid: str):
        c = self._container(cid)
        if c.state == "running":
            c.state = "exited"
            c.exit_code = 0
            self._log(cid, "stop\n")
        return {"status": "exited"}

    def cmd_restart(self, cid: str, *args, **kw):
        self.cmd_stop(cid)
        return self.cmd_start(cid, *args, **kw)

    def cmd_kill(self, cid: str):
        c = self._container(cid)
        c.state = "dead"
        c.exit_code = 137
        self._log(cid, "killed\n")
        return {"status": "dead"}

    def cmd_rm(self, cid: str):
        c = self._container(cid)
        if c.state == "running":
            raise ContainerError("cannot rm a running container")
        self._containers.pop(cid)
        # whole container subtree: log, rootfs params (job.json), layer
        # symlinks and the upper dir — nothing strands λFS space
        self.fs.rmtree(f"/containers/{cid}", PRIVATE_NS)

    # -- monitoring ---------------------------------------------------------------

    def cmd_logs(self, cid: str) -> bytes:
        return self.fs.read(f"/containers/{cid}/rootfs/log", PRIVATE_NS)

    def cmd_ps(self) -> List[dict]:
        return [{"id": c.cid, "image": c.image, "state": c.state,
                 "exit_code": c.exit_code}
                for c in self._containers.values()]

    # -- internals ------------------------------------------------------------------

    def _container(self, cid: str) -> ISPContainer:
        if cid not in self._containers:
            raise ContainerError(f"no container {cid}")
        return self._containers[cid]

    def _log(self, cid: str, msg: str):
        self.fs.append(f"/containers/{cid}/rootfs/log", msg.encode(),
                       PRIVATE_NS)


class ContainerContext:
    """What a containerized app sees: namespaced FS, syscalls, logging,
    cgroup memory accounting."""

    def __init__(self, docker: MiniDocker, container: ISPContainer):
        self._docker = docker
        self.c = container
        self.fw = docker.fw
        self.fs = docker.fs
        self.extents = docker.extents

    def log(self, msg: str):
        self._docker._log(self.c.cid, msg if msg.endswith("\n") else msg + "\n")

    def syscall(self, name: str, *a, **kw):
        return self.fw.syscall(name, *a, **kw)

    def alloc(self, nbytes: int):
        if self.c.mem_used + nbytes > self.c.mem_budget:
            raise ContainerOOM(
                f"cgroup budget exceeded: {self.c.mem_used + nbytes} > "
                f"{self.c.mem_budget}")
        self.c.mem_used += nbytes

    def free(self, nbytes: int):
        self.c.mem_used = max(0, self.c.mem_used - nbytes)

    def bind(self, path: str):
        """Bind a sharable-NS file for processing (takes the inode lock)."""
        return self.fs.container_bind(path, self.c.cid, SHARABLE_NS)

    def release(self, path: str):
        self.fs.container_release(path, self.c.cid, SHARABLE_NS)
