"""λFS — DockerSSD's backend media manager.

Reproduces the paper's design: the media is partitioned into two NVMe
namespaces —

  * **private-NS** — container/OS-virtualization runtime state
    (``/images/``, ``/containers/<id>/rootfs/``); *invisible to the
    host* (host access raises ``PermissionError``).
  * **sharable-NS** — data the host places/retrieves and ISP-containers
    process; guarded by **inode locks**: a reference counter on the
    host-VFS inode, synchronized over Ether-oN.  A file is accessible
    to an ISP-container only when the host refcount is zero; while the
    container holds the lock the host's inode cache is invalidated.
    Locks are synchronization-only and non-persistent (power failure
    clears them; the host restores the FS and restarts the container).

Also implements the I/O-handler services the paper lists: *path
walking* (LBA->filename mapping) with an *I/O-node cache*, plus
counters that feed the Fig-3/Fig-11 cost models.

The port's copy of ``repro.core.lambda_fs`` (pure Python).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

PRIVATE_NS = "private"
SHARABLE_NS = "sharable"
BLOCK = 4096


class LambdaFSError(Exception):
    pass


class LockHeld(LambdaFSError):
    pass


@dataclasses.dataclass
class Inode:
    ino: int
    path: str
    kind: str                   # "file" | "dir" | "symlink"
    ns: str
    data: bytes = b""
    target: str = ""            # symlink target
    host_refcount: int = 0      # host VFS openers (inode lock)
    container_holder: Optional[str] = None
    ctime: float = 0.0


class Stats:
    def __init__(self):
        self.path_walks = 0
        self.node_cache_hits = 0
        self.reads = self.writes = 0
        self.bytes_read = self.bytes_written = 0
        self.lock_syncs = 0


class LambdaFS:
    """One DockerSSD's filesystem.  Thread-safe; deterministic."""

    def __init__(self, capacity_bytes: int = 400 * 10 ** 9):
        self._lock = threading.RLock()
        self.capacity = capacity_bytes
        self.used = 0
        self._next_ino = 2
        self._inodes: Dict[str, Inode] = {}      # (ns, path) keyed
        self._node_cache: Dict[str, int] = {}    # path -> ino (I/O node cache)
        self.stats = Stats()
        self._ether = None                        # Ether-oN hook (lock sync)
        for ns in (PRIVATE_NS, SHARABLE_NS):
            self._inodes[self._key(ns, "/")] = Inode(
                1, "/", "dir", ns)

    def attach_ether(self, ether):
        self._ether = ether

    @staticmethod
    def _key(ns, path):
        return f"{ns}:{path.rstrip('/') or '/'}"

    # -- path walking (LBA -> filename mapping, with node cache) ------------

    def _walk(self, ns: str, path: str, *, create_dirs: bool = False) -> str:
        """Walk components, counting walks; returns normalized path."""
        parts = [p for p in path.split("/") if p]
        cur = ""
        for comp in parts[:-1] if parts else []:
            cur += "/" + comp
            key = self._key(ns, cur)
            if key in self._node_cache:
                self.stats.node_cache_hits += 1
            else:
                self.stats.path_walks += 1
                if key not in self._inodes:
                    if not create_dirs:
                        raise FileNotFoundError(f"{ns}:{cur}")
                    self._mknod(ns, cur, "dir")
                self._node_cache[key] = self._inodes[key].ino
        return "/" + "/".join(parts)

    def _mknod(self, ns, path, kind) -> Inode:
        ino = Inode(self._next_ino, path, kind, ns, ctime=time.monotonic())
        self._next_ino += 1
        self._inodes[self._key(ns, path)] = ino
        return ino

    def _get(self, ns, path) -> Inode:
        key = self._key(ns, path)
        if key not in self._inodes:
            raise FileNotFoundError(key)
        node = self._inodes[key]
        if node.kind == "symlink":
            return self._get(ns, node.target)
        return node

    # -- namespace protection ------------------------------------------------

    def _check_host_access(self, ns):
        if ns == PRIVATE_NS:
            raise PermissionError(
                "private-NS is exposed only on Virtual-FW's PCIe function; "
                "the host's function maps the sharable-NS only")

    # -- inode locks (host <-> ISP-container concurrency) --------------------

    def host_open(self, path: str, ns: str = SHARABLE_NS) -> Inode:
        with self._lock:
            self._check_host_access(ns)
            node = self._get(ns, self._walk(ns, path))
            if node.container_holder is not None:
                raise LockHeld(f"{path} held by ISP-container "
                               f"{node.container_holder}")
            node.host_refcount += 1
            self._sync_lock(node)
            return node

    def host_close(self, path: str, ns: str = SHARABLE_NS):
        with self._lock:
            self._check_host_access(ns)
            node = self._get(ns, path)
            if node.host_refcount <= 0:
                raise LambdaFSError("close without open")
            node.host_refcount -= 1
            self._sync_lock(node)

    def container_bind(self, path: str, container_id: str,
                       ns: str = SHARABLE_NS) -> Inode:
        """Bind a host FS file/dir into λFS for processing.  Grantable only
        when the host inode refcount is zero."""
        with self._lock:
            node = self._get(ns, self._walk(ns, path))
            if node.host_refcount != 0:
                raise LockHeld(f"{path} opened by host "
                               f"(refcount={node.host_refcount})")
            if (node.container_holder is not None
                    and node.container_holder != container_id):
                raise LockHeld(f"{path} held by {node.container_holder}")
            node.container_holder = container_id
            self._sync_lock(node)   # host VFS invalidates its inode cache
            return node

    def container_release(self, path: str, container_id: str,
                          ns: str = SHARABLE_NS):
        with self._lock:
            node = self._get(ns, path)
            if node.container_holder != container_id:
                raise LambdaFSError("release by non-holder")
            node.container_holder = None
            self._sync_lock(node)

    def _sync_lock(self, node):
        """Send the lock-sync special packet over Ether-oN (if attached)."""
        self.stats.lock_syncs += 1
        if self._ether is not None:
            self._ether.send_lock_sync(node.path, node.host_refcount,
                                       node.container_holder)

    def power_failure(self):
        """Locks are non-persistent: a crash clears them (the host restores
        the FS and restarts ISP-containers from their initial state)."""
        with self._lock:
            for node in self._inodes.values():
                node.host_refcount = 0
                node.container_holder = None
            self._node_cache.clear()

    # -- file ops (used by the I/O handler + mini-docker) ---------------------

    def write(self, path: str, data: bytes, ns: str = PRIVATE_NS,
              actor: str = "fw"):
        with self._lock:
            if actor == "host":
                self._check_host_access(ns)
            norm = self._walk(ns, path, create_dirs=True)
            key = self._key(ns, norm)
            node = self._inodes.get(key) or self._mknod(ns, norm, "file")
            delta = len(data) - len(node.data)
            if self.used + delta > self.capacity:
                raise LambdaFSError("ENOSPC")
            self.used += delta
            node.data = data
            self.stats.writes += 1
            self.stats.bytes_written += len(data)

    def append(self, path: str, data: bytes, ns: str = PRIVATE_NS):
        with self._lock:
            try:
                old = self._get(ns, path).data
            except FileNotFoundError:
                old = b""
            self.write(path, old + data, ns)

    def read(self, path: str, ns: str = PRIVATE_NS,
             actor: str = "fw") -> bytes:
        with self._lock:
            if actor == "host":
                self._check_host_access(ns)
            node = self._get(ns, self._walk(ns, path))
            self.stats.reads += 1
            self.stats.bytes_read += len(node.data)
            return node.data

    def mkdir(self, path: str, ns: str = PRIVATE_NS):
        with self._lock:
            norm = self._walk(ns, path, create_dirs=True)
            if self._key(ns, norm) not in self._inodes:
                self._mknod(ns, norm, "dir")

    def symlink(self, target: str, path: str, ns: str = PRIVATE_NS):
        with self._lock:
            norm = self._walk(ns, path, create_dirs=True)
            node = self._mknod(ns, norm, "symlink")
            node.target = target

    def unlink(self, path: str, ns: str = PRIVATE_NS):
        with self._lock:
            key = self._key(ns, path)
            if key in self._inodes:
                node = self._inodes.pop(key)
                self.used -= len(node.data)
                self._node_cache.pop(key, None)

    def rmtree(self, path: str, ns: str = PRIVATE_NS):
        """Remove a directory subtree (every inode at or under ``path``)
        — container teardown must not strand rootfs files/symlinks."""
        with self._lock:
            prefix = self._key(ns, path)
            for key in [k for k in self._inodes
                        if k == prefix or k.startswith(prefix + "/")]:
                node = self._inodes.pop(key)
                self.used -= len(node.data)
                self._node_cache.pop(key, None)

    def listdir(self, path: str, ns: str = PRIVATE_NS):
        with self._lock:
            prefix = path.rstrip("/") + "/"
            out = []
            for key, node in self._inodes.items():
                kns, kpath = key.split(":", 1)
                if kns == ns and kpath.startswith(prefix) and kpath != prefix:
                    rest = kpath[len(prefix):]
                    if "/" not in rest:
                        out.append(rest)
            return sorted(out)

    def exists(self, path: str, ns: str = PRIVATE_NS) -> bool:
        try:
            self._get(ns, self._walk(ns, path))
            return True
        except (FileNotFoundError, LambdaFSError):
            return False
