"""Static accounting of collective communication in compiled XLA programs.

The reference has no distributed runtime to account for; here, where GSPMD
inserts every collective, this module makes the inserted communication
*auditable*: parse a compiled module's HLO text and report each
collective's payload bytes and group size.  Used by the parallelism tests
(``tests/test_parallel.py``) to lock per-step collective BYTE budgets —
not just op counts.

Byte counts are the payload of the collective's result shape.  For an
all-reduce of payload ``B`` over a ring of ``g`` devices, the per-device
link traffic is ``2 B (g-1)/g`` (reduce-scatter + all-gather phases),
which a roofline of the interconnect applies on top of these raw
payloads.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "all-to-all", "collective-permute")

# `%name = <shape> all-reduce(...)` — the shape region is everything
# between `=` and the op keyword (non-greedy), so tuple shapes whose
# tiled layouts contain parentheses (`(f32[512]{0:T(512)}, ...)`) are
# captured whole.  `-start` variants are the async forms; their `-done`
# halves carry no new payload.
_OP_RE = re.compile(
    r"=\s*(?P<shape>.+?)\s+(?P<kind>"
    + "|".join(_COLLECTIVES) + r")(?P<start>-start)?\(")
_SHAPE_RE = re.compile(r"(?P<dtype>[a-z]+\d*)\[(?P<dims>[\d,]*)\]")
# Two replica_groups encodings appear in XLA text: the iota form
# `replica_groups=[ngroups,gsize]<=[...]` and the explicit-list form
# `replica_groups={{0,1},{2,3}}` (group size = first group's element count).
_GROUPS_RE = re.compile(r"replica_groups=\[(?P<ngroups>\d+),(?P<gsize>\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{(?P<first>[\d,]*)\}")
_OP_NAME_RE = re.compile(r'op_name="(?P<name>[^"]*)"')


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    kind: str          # all-reduce | all-gather | ...
    payload_bytes: int  # bytes in the result shape
    group_size: int     # devices participating (1 group's size; 0 if unknown)
    line: str           # the HLO line, for diagnostics
    # Loop-nesting depth from the op's `op_name` metadata: the number of
    # `while/body` segments in the traced path (e.g. a collective inside
    # epochs-scan -> rounds-scan -> steps-scan is depth 3, a per-epoch
    # gather is depth 1, a loop-free op is 0).  -1 when the line carries
    # no op_name metadata.  This is what lets a MULTI-loop program's byte
    # budget be locked per execution frequency: static HLO text shows each
    # op once regardless of trip count, so "the dataset-sized collective
    # runs per epoch, not per step" is exactly "its depth is 1, not 3".
    loop_depth: int = -1


def _element_bytes(shape: str):
    """Byte size of every tensor in a (possibly tuple) shape string."""
    out = []
    for m in _SHAPE_RE.finditer(shape):
        nbytes = _DTYPE_BYTES.get(m.group("dtype"))
        if nbytes is None:
            continue
        n = 1
        dims = m.group("dims")
        if dims:
            for d in dims.split(","):
                n *= int(d)
        out.append(n * nbytes)
    return out


def _shape_bytes(shape: str, is_start: bool) -> int:
    """Payload bytes of one collective's result shape.

    Sync forms: the result IS the payload; a tuple result is a fused
    multi-tensor collective, so elements SUM.  Async ``-start`` forms
    return ``(operand, result[, scratch])`` — summing would double-count
    — and the wire payload is bounded by the LARGEST element (all-reduce:
    operand == result; all-gather: result; reduce-scatter: operand), so
    the max is taken.
    """
    sizes = _element_bytes(shape)
    if not sizes:
        return 0
    return max(sizes) if is_start else sum(sizes)


def collective_ops(hlo_text: str) -> List[CollectiveOp]:
    """All collective ops in an HLO module text (``compiled.as_text()``).

    Each op is counted once per appearance in the text; ops inside a
    ``while`` body therefore count once per loop *body*, not per
    iteration — account for trip counts at the call site (the tests use
    loop-free per-step programs so the static count IS the per-step
    count).
    """
    ops = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        g = _GROUPS_RE.search(line)
        if g:
            group_size = int(g.group("gsize"))
        else:
            gl = _GROUPS_LIST_RE.search(line)
            group_size = (len(gl.group("first").split(","))
                          if gl and gl.group("first") else 0)
        payload = _shape_bytes(m.group("shape"),
                               m.group("start") is not None)
        if (group_size == 0 and payload > 0
                and m.group("kind") != "collective-permute"
                and "replica_groups={}" not in line):
            # A grouped collective with payload but unparsed replica_groups
            # would silently corrupt downstream roofline math (2B(g-1)/g) —
            # fail loudly.  collective-permute has source_target_pairs
            # instead, and empty replica_groups={} means "all devices"
            # (size not recoverable from the op line); both keep
            # group_size=0 = unknown, as documented on CollectiveOp.
            raise ValueError(
                "unparsed replica_groups on a collective with payload: "
                + line.strip())
        nm = _OP_NAME_RE.search(line)
        depth = nm.group("name").count("while/body") if nm else -1
        ops.append(CollectiveOp(
            kind=m.group("kind"),
            payload_bytes=payload,
            group_size=group_size,
            line=line.strip(),
            loop_depth=depth))
    return ops


def collective_bytes(hlo_text: str) -> int:
    """Total collective payload bytes in the module (see
    :func:`collective_ops` for the per-appearance semantics)."""
    return sum(op.payload_bytes for op in collective_ops(hlo_text))
