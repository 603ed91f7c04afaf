"""Device resolution for every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``"cuda"`` unless the caller names another device.

    Raises ``RuntimeError`` when a CUDA device is asked for (the
    default) and no card is present: the port never falls back to the
    CPU on its own; pass ``device="cpu"`` for the plain PyTorch path.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # float32 matmuls and convolutions stay full float32 (no TF32):
        # the port is held to the JAX reference at float32 tolerances
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def diagnose_cuda() -> str:
    """Name the other processes that hold the card, and the memory
    ledger's last verdict: the port's ``Engine.diagnose_tpu``.

    A pure ``/proc`` scan for processes other than this one that map
    ``libcuda`` or hold a ``/dev/nvidia*`` file open, plus the ledger's
    host-side totals and its LAST reconcile.  It never calls into CUDA,
    so it is safe from a watchdog thread while a kernel is wedged, or on
    a thread that is capturing a CUDA graph.
    """
    import os
    notes = []
    me = os.getpid()
    try:
        pids = [p for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        pids = []
    for pid in pids:
        if int(pid) == me:
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(
                    errors="replace").strip()
        except OSError:
            continue
        if not cmd:
            continue
        held = []
        try:
            for fd in os.listdir(f"/proc/{pid}/fd"):
                try:
                    target = os.readlink(f"/proc/{pid}/fd/{fd}")
                except OSError:
                    continue
                if target.startswith("/dev/nvidia"):
                    held.append(target)
        except OSError:
            pass
        if held:
            notes.append(f"pid {pid} holds {', '.join(sorted(set(held)))}: "
                         f"{cmd[:120]}")
            continue
        try:
            with open(f"/proc/{pid}/maps", "r", errors="replace") as f:
                if "libcuda" in f.read():
                    notes.append(f"pid {pid} maps libcuda: {cmd[:120]}")
        except OSError:
            continue
    notes.extend(_diagnose_memory())
    return "; ".join(notes) if notes else "no other CUDA holder found"


def _diagnose_memory() -> list:
    """The memory ledger's host-side totals and its last reconcile
    verdict (never a fresh allocator read)."""
    try:
        from bigdl_tpu_torch.obs.ledger import get_ledger
        s = get_ledger().summary()
    except Exception:
        return []
    if not s["entries"] and not s["executables"]:
        return []
    last = s.get("last_reconcile") or {}
    drift = last.get("drift_bytes")
    verdict = last.get("verdict", "never_run")
    return [f"memory: ledger={s['ledger_bytes']}B across "
            f"{s['subsystems']} subsystems, "
            f"{s['executables']} executables, "
            f"drift={drift if drift is not None else 'n/a'} "
            f"({verdict})"]
