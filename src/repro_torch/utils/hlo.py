"""Collective-traffic accounting from compiled (SPMD-partitioned) HLO text
(port of ``repro/utils/hlo.py``: the same parser, which needs only ``re``
and ``dataclasses``).

Nothing in the port emits HLO. The parser is kept so that the port's
dry-run records read the same way as the reference's, and its
``CollectiveStats`` is the accumulator of the port's own collective count
(``launch/dryrun.py::collectives_from_specs``, from the sharding specs).

On XLA's text, as the reference documents it:

* the partitioned module is the *per-device* program — every shape in it is
  a shard shape, so totals here are per-device; multiply by chip count for
  global traffic;
* operands of an instruction are printed as bare ``%name`` references, so we
  first build a name -> byte-size symbol table per computation, then resolve
  collective operands through it.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "f8e4m3": 1, "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "s4": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "u4": 1,
    "pred": 1, "c64": 8, "c128": 16,
}

# one tensor type, e.g. ``bf16[128,4096]{1,0:T(8,128)}`` or ``f32[]``
_TENSOR_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# an instruction definition: ``%name = <type...> opcode(...)``
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\(?[^=]*?)\s([\w\-]+)\((.*)$")
_COMPUTATION_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->")

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "ragged-all-to-all", "collective-broadcast",
)


def _type_bytes(type_str: str) -> int:
    """Total bytes of a (possibly tuple) HLO type string."""
    total = 0
    for dtype, dims in _TENSOR_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue  # e.g. sharding annotations; tokens
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclass
class CollectiveStats:
    """Per-device collective traffic, by op kind."""
    bytes_by_op: dict = field(default_factory=dict)
    count_by_op: dict = field(default_factory=dict)
    instances: list = field(default_factory=list)  # (op, bytes, line-head)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    def merge_scaled(self, other: "CollectiveStats", scale: float) -> None:
        """Add ``scale`` copies of ``other`` (scan-body trip-count fixup)."""
        for k, v in other.bytes_by_op.items():
            self.bytes_by_op[k] = self.bytes_by_op.get(k, 0) + int(v * scale)
        for k, v in other.count_by_op.items():
            self.count_by_op[k] = self.count_by_op.get(k, 0) + int(v * scale)

    def summary(self) -> dict:
        return {
            "total_bytes": self.total_bytes,
            "bytes_by_op": dict(sorted(self.bytes_by_op.items())),
            "count_by_op": dict(sorted(self.count_by_op.items())),
        }


def collective_stats(hlo_text: str) -> CollectiveStats:
    """Sum operand bytes of every collective in a compiled HLO module."""
    stats = CollectiveStats()
    # symbol tables are per-computation; HLO indents instructions and opens a
    # computation with ``%name (args) -> type {``.
    sym: dict = {}
    for raw in hlo_text.splitlines():
        line = raw.rstrip()
        if _COMPUTATION_RE.match(line.strip()) and line.strip().endswith("{"):
            sym = {}
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, out_type, opcode, operand_tail = m.groups()
        out_bytes = _type_bytes(out_type)
        sym[name] = out_bytes
        base_op = opcode.replace("-start", "").replace("-done", "")
        if base_op not in COLLECTIVE_OPS or opcode.endswith("-done"):
            continue
        # resolve operand references through the symbol table; fall back to
        # inline-typed operands, then to output size (all-reduce & permute
        # preserve shape).
        # cut at the attribute section (operands end at the first ')')
        operands = operand_tail
        depth, end = 0, len(operands)
        for i, ch in enumerate(operands):
            if ch == "(":
                depth += 1
            elif ch == ")":
                if depth == 0:
                    end = i
                    break
                depth -= 1
        operand_str = operands[:end]
        op_bytes = 0
        for ref in re.findall(r"%([\w.\-]+)", operand_str):
            op_bytes += sym.get(ref, 0)
        if op_bytes == 0:
            op_bytes = _type_bytes(operand_str)
        if op_bytes == 0:
            op_bytes = out_bytes
        stats.bytes_by_op[base_op] = stats.bytes_by_op.get(base_op, 0) + op_bytes
        stats.count_by_op[base_op] = stats.count_by_op.get(base_op, 0) + 1
        stats.instances.append((base_op, op_bytes, line.strip()[:100]))
    return stats


def scan_trip_counts(hlo_text: str) -> list:
    """Best-effort extraction of while-loop trip counts (for reporting).

    XLA lowers ``lax.scan`` to a while loop whose condition compares the
    induction variable against a constant; we scrape those constants so the
    roofline report can show which loops the single-count fixup applies to.
    """
    counts = []
    for m in re.finditer(r"constant\((\d+)\)[^\n]*\n[^\n]*compare", hlo_text):
        counts.append(int(m.group(1)))
    return counts
