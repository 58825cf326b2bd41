"""Virtual-FW — the lightweight firmware stack.

Reproduces the paper's design points:

  * **Three handlers** between HIL and ICL: thread (65 syscalls), I/O
    (43), network (25) — Table 1a.  System calls are emulated as plain
    function dispatch ("function management cost"), with NO user/kernel
    boundary: no context switch on return, unlike a fully-fledged OS.
  * **Memory pools**: page-granular FW-pool (handler tables; privileged
    mode only, enforced by the MPU model) and ISP-pool (call args and
    data).  Privileged mode may touch the ISP pool directly — no
    copy/mode-switch overhead between pools.
  * **TCP finite state machine** in the network handler.
  * **Binary footprint model** (Fig 10: ~83x smaller than Linux).

The cost constants let the Fig-3/Fig-11 models compare a Virtual-FW
syscall (function call) against host/embedded-Linux syscalls and
context switches.

The port's copy of ``repro.core.virtual_fw`` (pure Python).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

PAGE = 4096

# latency constants (us) used by the perf models
FUNC_CALL_US = 0.05          # Virtual-FW emulated syscall ~ function cost
HOST_SYSCALL_US = 0.8        # 3.8 GHz host kernel crossing
EMBEDDED_SYSCALL_US = 2.6    # full Linux on 2.2 GHz embedded cores
CONTEXT_SWITCH_US = 4.0      # kernel context switch

# Fig 10: binary sizes (bytes)
LINUX_BINARY_BYTES = int(250e6)          # kernel+rootfs userland stack
VIRTUAL_FW_BYTES = int(LINUX_BINARY_BYTES / 83.4)

THREAD_SYSCALLS = [
    # process management
    "fork", "vfork", "execve", "exit", "exit_group", "wait4", "waitid",
    "getpid", "getppid", "gettid", "clone", "kill", "tgkill", "rt_sigaction",
    "rt_sigprocmask", "rt_sigreturn", "sigaltstack", "setpgid", "getpgid",
    "setsid", "getsid", "prctl", "arch_prctl", "sched_yield",
    "sched_getaffinity", "sched_setaffinity", "getpriority", "setpriority",
    # memory management
    "brk", "mmap", "munmap", "mprotect", "mremap", "msync", "madvise",
    "mlock", "munlock", "membarrier",
    # IPC
    "pipe", "pipe2", "mq_open", "mq_unlink", "mq_timedsend",
    "mq_timedreceive", "shmget", "shmat", "shmdt", "semget", "semop",
    "msgget", "msgsnd", "msgrcv",
    # lock & signal mgmt
    "futex", "set_robust_list", "get_robust_list", "nanosleep",
    "clock_gettime", "clock_nanosleep", "timer_create", "timer_settime",
    "timerfd_create", "timerfd_settime", "eventfd2", "signalfd4",
    "getrusage",
]
IO_SYSCALLS = [
    # file/dir mgmt
    "openat", "open", "creat", "close", "mkdir", "mkdirat", "rmdir",
    "rename", "renameat", "unlink", "unlinkat", "getdents64", "getcwd",
    "chdir", "fchdir", "truncate", "ftruncate", "statx", "fstat", "newfstatat",
    # file I/O & link
    "read", "write", "pread64", "pwrite64", "readv", "writev", "lseek",
    "symlink", "symlinkat", "readlink", "readlinkat", "link", "linkat",
    "fsync", "fdatasync", "fallocate", "copy_file_range", "sendfile",
    # permission
    "chmod", "fchmod", "chown", "fchown", "umask",
]
NETWORK_SYSCALLS = [
    # polling
    "epoll_create", "epoll_create1", "epoll_ctl", "epoll_wait", "poll",
    "ppoll", "select", "pselect6",
    # socket
    "socket", "socketpair", "bind", "listen", "accept", "accept4",
    "connect", "shutdown", "getsockname", "getpeername", "setsockopt",
    "getsockopt",
    # comm
    "sendto", "recvfrom", "sendmsg", "recvmsg", "sendmmsg",
]
assert len(THREAD_SYSCALLS) == 65, len(THREAD_SYSCALLS)
assert len(IO_SYSCALLS) == 43, len(IO_SYSCALLS)
assert len(NETWORK_SYSCALLS) == 25, len(NETWORK_SYSCALLS)


class MPUViolation(Exception):
    pass


class MemoryPools:
    """Bare-metal DRAM in page-granular partitions."""

    def __init__(self, fw_pages: int = 4096, isp_pages: int = 262144):
        self.fw_pool = {}
        self.isp_pool = {}
        self.fw_pages = fw_pages
        self.isp_pages = isp_pages
        self.privileged = False

    def fw_write(self, page: int, value):
        if not self.privileged:
            raise MPUViolation("FW-pool requires privileged CPU mode")
        self.fw_pool[page] = value

    def fw_read(self, page: int):
        if not self.privileged:
            raise MPUViolation("FW-pool requires privileged CPU mode")
        return self.fw_pool.get(page)

    def isp_write(self, page: int, value):
        # privileged mode accesses the ISP pool directly (no copy between
        # pools, no mode-switch overhead) — and so does user mode.
        self.isp_pool[page] = value

    def isp_read(self, page: int):
        return self.isp_pool.get(page)


class TCPConn:
    STATES = ["CLOSED", "LISTEN", "SYN_SENT", "SYN_RCVD", "ESTABLISHED",
              "FIN_WAIT_1", "FIN_WAIT_2", "CLOSE_WAIT", "LAST_ACK",
              "TIME_WAIT"]
    _T = {
        ("CLOSED", "passive_open"): "LISTEN",
        ("CLOSED", "active_open"): "SYN_SENT",
        ("LISTEN", "syn"): "SYN_RCVD",
        ("SYN_SENT", "syn_ack"): "ESTABLISHED",
        ("SYN_RCVD", "ack"): "ESTABLISHED",
        ("ESTABLISHED", "close"): "FIN_WAIT_1",
        ("ESTABLISHED", "fin"): "CLOSE_WAIT",
        ("FIN_WAIT_1", "ack"): "FIN_WAIT_2",
        ("FIN_WAIT_2", "fin"): "TIME_WAIT",
        ("CLOSE_WAIT", "close"): "LAST_ACK",
        ("LAST_ACK", "ack"): "CLOSED",
        ("TIME_WAIT", "timeout"): "CLOSED",
    }

    def __init__(self):
        self.state = "CLOSED"

    def event(self, ev: str):
        key = (self.state, ev)
        if key not in self._T:
            raise ValueError(f"invalid TCP transition {key}")
        self.state = self._T[key]
        return self.state


class VirtualFW:
    """Firmware runtime: handler dispatch + λFS + network FSM."""

    def __init__(self, fs, endpoint=None):
        self.fs = fs
        self.endpoint = endpoint
        self.pools = MemoryPools()
        self.syscall_counts: Dict[str, int] = {}
        self.emulated_us = 0.0
        self._fds: Dict[int, str] = {}
        self._next_fd = 3
        self._next_isp_page = 0
        self._conns: Dict[int, TCPConn] = {}
        self._handler_of = {}
        for name in THREAD_SYSCALLS:
            self._handler_of[name] = "thread"
        for name in IO_SYSCALLS:
            self._handler_of[name] = "io"
        for name in NETWORK_SYSCALLS:
            self._handler_of[name] = "network"
        # install handler tables in the FW pool (privileged)
        self.pools.privileged = True
        self.pools.fw_write(0, {"thread": THREAD_SYSCALLS,
                                "io": IO_SYSCALLS,
                                "network": NETWORK_SYSCALLS})
        self.pools.privileged = False

    # -- syscall emulation: a plain function dispatch -------------------------

    def syscall(self, name: str, *args, **kw):
        if name not in self._handler_of:
            raise NotImplementedError(f"syscall {name} not emulated")
        self.syscall_counts[name] = self.syscall_counts.get(name, 0) + 1
        self.emulated_us += FUNC_CALL_US   # no kernel boundary, no ctx switch
        impl = getattr(self, f"_sys_{name}", None)
        if impl is not None:
            return impl(*args, **kw)
        return 0  # table-dispatched no-op (counted, costed)

    # representative functional implementations
    def _sys_openat(self, path, ns="private", **kw):
        fd = self._next_fd
        self._next_fd += 1
        self._fds[fd] = (ns, path)
        return fd

    _sys_open = _sys_openat

    def _sys_close(self, fd):
        self._fds.pop(fd, None)
        for c in list(self._conns):
            if c == fd:
                self._conns.pop(c)
        return 0

    def _sys_read(self, fd, n=-1):
        ns, path = self._fds[fd]
        data = self.fs.read(path, ns)
        return data if n < 0 else data[:n]

    def _sys_write(self, fd, data: bytes):
        ns, path = self._fds[fd]
        self.fs.append(path, data, ns)
        return len(data)

    def _sys_mkdir(self, path, ns="private"):
        self.fs.mkdir(path, ns)
        return 0

    def _sys_symlink(self, target, path, ns="private"):
        self.fs.symlink(target, path, ns)
        return 0

    def _sys_socket(self, *a):
        fd = self._next_fd
        self._next_fd += 1
        self._conns[fd] = TCPConn()
        return fd

    def _sys_bind(self, fd, addr):
        return 0

    def _sys_listen(self, fd, backlog=16):
        self._conns[fd].event("passive_open")
        return 0

    def _sys_connect(self, fd, addr):
        self._conns[fd].event("active_open")
        self._conns[fd].event("syn_ack")
        return 0

    def _sys_accept(self, fd):
        conn_fd = self._sys_socket()
        self._conns[conn_fd].event("passive_open")
        self._conns[conn_fd].event("syn")
        self._conns[conn_fd].event("ack")
        return conn_fd

    def _sys_sendto(self, fd, data: bytes, dst_ip: str = "10.0.0.1"):
        if self.endpoint is not None:
            self.endpoint.send_to_host(data, dst_ip)
        return len(data)

    # -- ISP job buffers (call args in the ISP memory pool) --------------------

    def stage_job(self, payload: bytes) -> List[int]:
        """Copy call args into page-granular ISP-pool buffers.

        The ISP pool is user-mode accessible (no copy or mode switch
        between pools — the paper's point); the FW pool would trap in
        the MPU model.  The pool is finite (``MemoryPools.isp_pages``):
        callers must :meth:`free_job` when the job retires.  Returns the
        page ids the containerized app reads back with
        :meth:`read_job`."""
        n = max(1, -(-len(payload) // PAGE))
        if len(self.pools.isp_pool) + n > self.pools.isp_pages:
            raise MemoryError(
                f"ISP pool exhausted: {len(self.pools.isp_pool)} pages "
                f"in use of {self.pools.isp_pages}, need {n} more")
        pages = []
        for off in range(0, max(len(payload), 1), PAGE):
            pid = self._next_isp_page
            self._next_isp_page += 1
            self.pools.isp_write(pid, payload[off:off + PAGE])
            pages.append(pid)
        return pages

    def read_job(self, pages: List[int]) -> bytes:
        return b"".join(self.pools.isp_read(p) or b"" for p in pages)

    def free_job(self, pages: List[int]):
        for p in pages:
            self.pools.isp_pool.pop(p, None)

    # -- footprint model (Fig 10) ---------------------------------------------

    @staticmethod
    def binary_footprint() -> dict:
        return {
            "linux_bytes": LINUX_BINARY_BYTES,
            "virtual_fw_bytes": VIRTUAL_FW_BYTES,
            "reduction": LINUX_BINARY_BYTES / VIRTUAL_FW_BYTES,
        }
