r"""Shared checkpoint format: checksum + schema-versioned header.

One writer/loader for every engine's checkpoint (the serial Explorer,
the parallel engine's level-barrier checkpoints, and the device modes'
`_write_ck`), replacing bare-pickle files.  TLC treats
periodic checkpointing as table stakes for long runs (SURVEY.md §5,
testout1:10); what the bare pickles lacked was INTEGRITY: a clipped or
bit-rotted file unpickled into garbage (or half-garbage) and the resume
either crashed with a stack trace or silently continued from a wrong
state.  The format here makes every failure mode a one-line refusal:

    JMCKPT1\n  <4-byte big-endian header length>  <JSON header>  <pickle>

The header carries the container schema version, the engine `kind`
("interp" for the host engines' shared state-table format, "device" for
the lane-encoded device formats), the payload byte length, and the
payload's sha256.  `load_checkpoint` verifies all four before a single
pickle byte is trusted and raises `CkptError` — a ValueError subclass
with an actionable one-liner — on any mismatch.  cli.py maps CkptError
to exit status 2 (usage/error), never a traceback.

Writes are atomic (sibling tmp file + fsync + os.replace), so a crash
mid-write leaves the previous checkpoint intact.  The ckpt_corrupt
fault site (jaxmc_torch/faults.py) damages the file AFTER the rename — the
test harness for post-write disk corruption.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import struct
from typing import Any, Dict, Optional, Tuple

from .. import faults

MAGIC = b"JMCKPT1\n"
CKPT_SCHEMA = 1  # container schema (payload schemas are the engines')

_REMEDY = ("fall back to an older checkpoint or restart the run from "
           "scratch")


class CkptError(ValueError):
    """A checkpoint cannot be written/read/trusted. The message is a
    complete one-line diagnosis + remedy; cli.py maps it to exit 2."""


def write_checkpoint(path: str, kind: str, meta: Dict[str, Any],
                     payload: Dict[str, Any]) -> int:
    """Atomically write `payload` under a checksummed header.  Returns
    the total bytes written (telemetry).  Raises CkptError on I/O
    failure (disk full mid-checkpoint must not kill the search — the
    engines catch and keep running on the previous checkpoint)."""
    body = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    header = {"schema": CKPT_SCHEMA, "kind": kind,
              "sha256": hashlib.sha256(body).hexdigest(),
              "payload_bytes": len(body), "meta": meta}
    hb = json.dumps(header, sort_keys=True).encode("utf-8")
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as fh:
            fh.write(MAGIC)
            fh.write(struct.pack(">I", len(hb)))
            fh.write(hb)
            fh.write(body)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except OSError as ex:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise CkptError(f"cannot write checkpoint {path}: {ex}")
    faults.corrupt_file("ckpt_corrupt", path, kind=kind)
    return len(MAGIC) + 4 + len(hb) + len(body)


def _read_header_at(path: str) -> Tuple[Dict[str, Any], int]:
    """(header, payload byte offset).  The offset is the ACTUAL file
    position after the header bytes — never re-derived by re-serializing
    the parsed JSON, which could differ byte-for-byte from what the
    writer produced."""
    try:
        with open(path, "rb") as fh:
            magic = fh.read(len(MAGIC))
            if magic != MAGIC:
                raise CkptError(
                    f"cannot resume: {path} is not a jaxmc checkpoint "
                    f"(bad header — written by an incompatible jaxmc "
                    f"version or another tool?); re-run with a file "
                    f"written by --checkpoint")
            raw = fh.read(4)
            if len(raw) != 4:
                raise CkptError(
                    f"cannot resume: {path} is truncated inside the "
                    f"header; {_REMEDY}")
            (hlen,) = struct.unpack(">I", raw)
            hb = fh.read(hlen)
            offset = fh.tell()
    except FileNotFoundError:
        raise CkptError(
            f"cannot resume: no checkpoint at {path}; pass a file "
            f"written by --checkpoint")
    except OSError as ex:
        raise CkptError(f"cannot resume: {path} is unreadable ({ex})")
    if len(hb) != hlen:
        raise CkptError(
            f"cannot resume: {path} is truncated inside the header; "
            f"{_REMEDY}")
    try:
        header = json.loads(hb.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        raise CkptError(
            f"cannot resume: {path} has a corrupt header; {_REMEDY}")
    if not isinstance(header, dict) or "sha256" not in header:
        raise CkptError(
            f"cannot resume: {path} has a malformed header; {_REMEDY}")
    if header.get("schema") != CKPT_SCHEMA:
        raise CkptError(
            f"cannot resume: {path} uses checkpoint schema "
            f"{header.get('schema')!r}, this build reads "
            f"{CKPT_SCHEMA!r}; re-checkpoint with a matching jaxmc")
    return header, offset


def read_header(path: str) -> Dict[str, Any]:
    """Parse and sanity-check the header only (no payload read)."""
    return _read_header_at(path)[0]


def load_checkpoint(path: str, kind: Optional[str] = None
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Verify integrity end to end and return (header, payload).  Every
    defect is a CkptError naming the file, the defect, and the remedy —
    a corrupt checkpoint must never unpickle."""
    header, offset = _read_header_at(path)
    if kind is not None and header.get("kind") != kind:
        raise CkptError(
            f"cannot resume: {path} was written by the "
            f"{header.get('kind')!r} engine, this run expects {kind!r} "
            f"(re-run with the backend/flags of the writing run)")
    want = int(header.get("payload_bytes", -1))
    with open(path, "rb") as fh:
        fh.seek(offset)
        body = fh.read()
    if len(body) != want:
        raise CkptError(
            f"cannot resume: {path} is truncated ({len(body)} of {want} "
            f"payload bytes — the file was clipped after it was "
            f"written); {_REMEDY}")
    if hashlib.sha256(body).hexdigest() != header["sha256"]:
        raise CkptError(
            f"cannot resume: {path} failed its integrity check (sha256 "
            f"mismatch — the file is corrupt); {_REMEDY}")
    try:
        payload = pickle.loads(body)
    except Exception as ex:  # noqa: BLE001 — any unpickle defect
        raise CkptError(
            f"cannot resume: {path} passed its checksum but failed to "
            f"unpickle ({type(ex).__name__}: {ex}) — it was written by "
            f"an incompatible jaxmc build; {_REMEDY}")
    if not isinstance(payload, dict):
        raise CkptError(
            f"cannot resume: {path} does not hold a jaxmc checkpoint "
            f"payload; {_REMEDY}")
    return header, payload


def write_periodic(path: str, kind: str, meta: Dict[str, Any],
                   payload: Dict[str, Any], tel, log,
                   ck_state: Dict[str, Any],
                   span_attrs: Optional[Dict[str, Any]] = None) -> bool:
    """The engines' shared PERIODIC checkpoint write: span + the
    adaptive interval stretch (write cost capped at ~5% of wall, the
    serial engine's rule) + the TLC-style log line — and, crucially,
    NON-FATAL: a failed write (disk full, permissions) logs a warning
    and returns False so the search keeps running on the previous
    checkpoint instead of dying with all in-memory progress.  Resume-
    side defects stay fatal (load_checkpoint raises).  `ck_state` is the
    engine's {"every": seconds, ...} dict, mutated in place."""
    import time
    t_ck = time.time()
    try:
        with tel.span("checkpoint.write", **(span_attrs or {})):
            write_checkpoint(path, kind, meta, payload)
    except CkptError as ex:
        tel.counter("checkpoint.write_failures")
        log(f"WARNING: checkpoint write failed ({ex}); the run "
            f"continues on the previous checkpoint")
        return False
    write_s = time.time() - t_ck
    if write_s * 20.0 > ck_state["every"]:
        ck_state["every"] = write_s * 20.0
        log(f"Checkpoint write took {write_s:.1f}s; interval "
            f"stretched to {ck_state['every']:.0f}s")
    log(f"Checkpointing run to {path}")
    return True


# ------------------------------------------- the interp payload contract

def interp_payload(model, vars, states, parents, labels, depth_of,
                   queue, generated, diameter, seen, edges, collect_edges,
                   prints) -> Dict[str, Any]:
    """The host engines' shared checkpoint payload: the serial Explorer,
    the parallel engine's level barriers, and the device path's host
    snapshot all write THIS shape, so any of them can resume any
    other's checkpoint."""
    return dict(module=model.module.name, vars=list(vars),
                states=list(states), parents=list(parents),
                labels=list(labels), depth_of=list(depth_of),
                queue=list(queue), generated=generated,
                diameter=diameter, seen_items=list(seen.items()),
                edges=list(edges) if collect_edges else None,
                prints=list(prints))


def load_interp_checkpoint(path: str, model, vars,
                           collect_edges: bool) -> Dict[str, Any]:
    """Load + validate an interp-format checkpoint against THIS model
    and this run's needs.  Returns the payload dict; raises CkptError
    with the defect (wrong module/vars, missing edge log, ...)."""
    _, ck = load_checkpoint(path, kind="interp")
    if "states" not in ck or "seen_items" not in ck:
        raise CkptError(
            f"cannot resume: {path} was written by an incompatible "
            f"jaxmc version (missing state-table fields); {_REMEDY}")
    if ck.get("module") != model.module.name or \
            ck.get("vars") != list(vars):
        raise CkptError(
            f"cannot resume: checkpoint {path} is for module "
            f"{ck.get('module')!r} with variables {ck.get('vars')}, not "
            f"{model.module.name!r} — point --resume at a checkpoint "
            f"written for this spec")
    if collect_edges and ck.get("edges") is None:
        # liveness needs the FULL edge log; a checkpoint written
        # without one cannot support temporal checking
        raise CkptError(
            "cannot resume with temporal properties: the checkpoint "
            "has no edge log (it was written without PROPERTY "
            "obligations); re-run from scratch")
    return ck
