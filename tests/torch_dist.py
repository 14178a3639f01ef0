"""Spawned ranks over gloo on localhost for the port's multi-process tests
(tests/test_torch_mesh*.py).  No JAX here: the ranks import torch and the
port only, the JAX references run in the test's own process meanwhile.

Each group joins with its own init_process_group timeout (PG_TIMEOUT_S),
and `Ranks.join` has a deadline (JOIN_DEADLINE_S) past which it kills the
whole group and fails, so that a hang fails the test in under two
minutes.  A rank that raises fails the test with its traceback."""
import multiprocessing
import os
import queue
import socket
import time
import traceback

PG_TIMEOUT_S = 60
JOIN_DEADLINE_S = 100


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(fn, rank: int, world: int, port: int, args: tuple, q,
           device: str, backend) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        import torch
        torch.set_num_threads(1)
        from tcam_wsol_video_tpu_torch.parallel import mesh as pmesh
        pmesh.maybe_init_distributed(device, backend=backend,
                                     timeout_s=PG_TIMEOUT_S)
        out = fn(rank, world, *args)
        pmesh.shutdown()
        q.put((rank, "ok", out))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
        raise SystemExit(1)


class Ranks:
    """fn(rank, world, *args) in `world` spawned processes joined over
    gloo on the CPU (device "cuda": the card's, over `backend`); start at
    construction, results (in rank order) from join."""

    def __init__(self, fn, world: int, *args, device: str = "cpu",
                 backend=None):
        ctx = multiprocessing.get_context("spawn")
        self.q = ctx.Queue()
        self.world = world
        port = free_port()
        self.procs = [ctx.Process(target=_entry,
                                  args=(fn, r, world, port, args, self.q,
                                        device, backend),
                                  daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def _kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5)

    def join(self, deadline_s: float = JOIN_DEADLINE_S) -> list:
        end = time.monotonic() + deadline_s
        results, errors = {}, []
        while len(results) + len(errors) < self.world:
            try:
                rank, status, out = self.q.get(
                    timeout=max(0.1, end - time.monotonic()))
            except queue.Empty:
                self._kill()
                raise AssertionError(
                    f"ranks did not finish within {deadline_s} s "
                    f"(done: {sorted(results)}); the group was killed")
            if status == "ok":
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
        if errors:
            self._kill()
            raise AssertionError("\n".join(errors))
        for p in self.procs:
            p.join(max(1.0, end - time.monotonic()))
        self._kill()
        return [results[r] for r in range(self.world)]
