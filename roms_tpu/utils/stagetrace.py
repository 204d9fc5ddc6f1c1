"""Per-stage device time, kernel launches and bytes of a compiled step.

`stepping.step` wraps each stage in a ``jax.named_scope`` whose name is
one of STAGES (the tridiagonal solvers add ``vsolve`` inside the stage
that calls them).  The scope path lands in every HLO instruction's
``op_name`` metadata, and the profiler tags each device kernel with the
HLO instruction (``hlo_op``) it runs.  This module joins the two:

* ``parse_hlo(compiled.as_text())`` maps each kernel-launching
  instruction to its stage, its bytes (result plus operands, the
  quantity XLA's cost analysis calls "bytes accessed", with sliced and
  in-place-updated buffers counted by the slice, see _fusion_bytes)
  and how many times it runs per call (while-loop trip counts);
* ``device_events(trace_dir, module)`` reads the device kernels of a
  ``jax.profiler`` trace;
* ``stage_table(...)`` sums both per stage, per step;
* ``collective_table(device_planes(trace_dir), nsteps)`` counts each
  device's kernels, NCCL kernels and busy time (the sharded step).

The bytes are a model of the HLO's operands and results, not measured
DRAM traffic.  Used by scripts/trace_step.py and chip_smoke.py; tested
on a CPU trace in tests/.
"""

from __future__ import annotations

import glob
import os
import re
from collections import defaultdict

STAGES = ("forcing", "bulk_flux", "diag", "set_vbc", "kpp", "pre_step3d",
          "prsgrd", "t3dmix", "rhs3d", "uv3dmix", "gls", "fast_loop",
          "step3d_uv", "step3d_t", "biology", "sediment")
VSOLVE = "vsolve"
OTHER = "other"

_ITEMSIZE = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
             "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
             "f64": 8, "c64": 8, "c128": 16}
_SHAPE = re.compile(r"\b(" + "|".join(_ITEMSIZE) + r")\[([\d,]*)\]")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = (.*)$")
# opcodes that launch nothing on the device
_NO_KERNEL = {"parameter", "get-tuple-element", "tuple", "bitcast",
              "constant", "while", "conditional", "call", "after-all",
              "partition-id", "replica-id", "opt-barrier"}


def shape_bytes(text: str) -> int:
    """Bytes of every array shape written in `text`."""
    total = 0
    for dt, dims in _SHAPE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _ITEMSIZE[dt]
    return total


def stage_of(op_name: str):
    """(stage, in_vertical_solve) from an op_name scope path."""
    parts = op_name.split("/")
    stage = next((p for p in parts if p in STAGES), OTHER)
    return stage, VSOLVE in parts


def _balanced(s: str, i: int) -> int:
    """Index just past the bracket group opening at s[i]."""
    depth = 0
    for j in range(i, len(s)):
        if s[j] in "([{":
            depth += 1
        elif s[j] in ")]}":
            depth -= 1
            if depth == 0:
                return j + 1
    return len(s)


def _parse_instr(rhs: str):
    if rhs.startswith("("):
        end = _balanced(rhs, 0)
    else:
        end = rhs.index(" ")
    shape, rest = rhs[:end], rhs[end:].lstrip()
    p = rest.index("(")
    opcode = rest[:p]
    q = _balanced(rest, p)
    return shape, opcode, rest[p + 1:q - 1], rest[q:]


def _fusion_bytes(instrs, out_bytes, args, result):
    """Bytes a fusion reads and writes.  An argument used only as the
    sliced operand of dynamic-slices is read slice by slice; one used
    only as the buffer of the root dynamic-update-slice (updated in
    place) is not read, and the write is then the update, not the whole
    result.  Every other argument is read whole."""
    params, users, root = {}, defaultdict(list), None
    for name, opcode, operands, _, is_root in instrs:
        ops = re.findall(r"%([\w.\-]+)", operands)
        if opcode == "parameter":
            params[name] = int(operands)
        for pos, o in enumerate(ops):
            users[o].append((opcode, pos, name))
        if is_root:
            root = (name, opcode, ops)
    nbytes = result
    if root and root[1] == "dynamic-update-slice" and root[2][0] in params:
        nbytes = out_bytes.get(root[2][1], 0)
    for pname, idx in params.items():
        us = users.get(pname, [])
        if us and all(op == "dynamic-slice" and pos == 0
                      for op, pos, _ in us):
            nbytes += sum(out_bytes[n] for _, _, n in us)
        elif not (us and all(op == "dynamic-update-slice" and pos == 0 and
                             n == root[0] for op, pos, n in us)):
            nbytes += args[idx] if idx < len(args) else 0
    return nbytes


def parse_hlo(text: str) -> dict:
    """{instruction name: {stage, vsolve, bytes, count}} for every
    kernel-launching instruction of a compiled HLO module; ``count`` is
    how often it runs per call of the module."""
    comps = defaultdict(list)
    out_bytes = {}
    comp = None
    for line in text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            comp = line.split()[1 if line.startswith("ENTRY") else 0]
            comp = comp.lstrip("%")
            if line.startswith("ENTRY"):
                entry = comp
            continue
        m = _INSTR.match(line)
        if comp is None or not m:
            continue
        name, rhs = m.groups()
        try:
            shape, opcode, operands, attrs = _parse_instr(rhs)
        except ValueError:
            continue
        out_bytes[name] = shape_bytes(shape)
        comps[comp].append((name, opcode, operands, attrs,
                            line.lstrip().startswith("ROOT")))

    def own_stage(attrs):
        op = re.search(r'op_name="([^"]*)"', attrs)
        return stage_of(op.group(1) if op else "")

    fused = set()
    calls = defaultdict(list)  # computation -> [(callee, times, stage)]
    for c, instrs in comps.items():
        for name, opcode, operands, attrs, _ in instrs:
            for callee in re.findall(r"calls=%?([\w.\-]+)", attrs):
                fused.add(callee)
            if opcode == "while":
                trip = re.search(r'"known_trip_count":\{"n":"(\d+)"', attrs)
                n = int(trip.group(1)) if trip else 1
                body = re.search(r"body=%?([\w.\-]+)", attrs).group(1)
                cond = re.search(r"condition=%?([\w.\-]+)", attrs)
                calls[c].append((body, n, own_stage(attrs)))
                calls[c].append((cond.group(1), n + 1, own_stage(attrs)))
            elif opcode in ("call", "conditional"):
                for callee in re.findall(
                        r"(?:to_apply|branch_computations|true_computation|"
                        r"false_computation)=\{?%?([\w.\-]+)", attrs):
                    calls[c].append((callee, 1, own_stage(attrs)))

    # A loop or call body takes the stage of its call site.  JAX lowers
    # identical bodies once and XLA clones them per call site, so the
    # instructions of a clone keep the op_name of the first user (the
    # tracer corrector's spline solves would read as step3d_uv).
    count = defaultdict(int)
    inherited = {}

    def visit(c, n, inh):
        count[c] += n
        inherited[c] = inh
        for callee, k, (stage, vs) in calls.get(c, ()):
            visit(callee, n * k,
                  (inh[0] if inh[0] != OTHER else stage, inh[1] or vs))

    visit(entry, 1, (OTHER, False))
    info = {}
    for c, instrs in comps.items():
        if c in fused or count[c] == 0:
            continue
        inh_stage, inh_vs = inherited[c]
        for name, opcode, operands, attrs, _ in instrs:
            if opcode in _NO_KERNEL:
                continue
            stage, vs = (own_stage(attrs) if inh_stage == OTHER
                         else (inh_stage, inh_vs))
            args = [out_bytes.get(o, 0)
                    for o in re.findall(r"%([\w.\-]+)", operands)]
            callee = re.search(r"calls=%?([\w.\-]+)", attrs)
            if opcode == "fusion" and callee:
                nbytes = _fusion_bytes(comps[callee.group(1)], out_bytes,
                                       args, out_bytes[name])
            else:
                nbytes = out_bytes[name] + sum(args)
            info[name] = {"stage": stage, "vsolve": vs, "bytes": nbytes,
                          "count": count[c]}
    return info


def _newest_profile(trace_dir: str):
    from jax.profiler import ProfileData
    files = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    return ProfileData.from_file(files[-1])


def device_events(trace_dir: str, module: str):
    """[(hlo_op, kernel_name, start_ns, duration_ns)] of the device
    kernels of HLO module `module` in the newest trace under `trace_dir`.
    Events come from the device planes ("/device:..."); a trace without
    any (the CPU backend) falls back to the host threads that ran the
    module."""
    pd = _newest_profile(trace_dir)
    planes = [p for p in pd.planes if p.name.startswith("/device:")]
    if not planes:
        planes = [p for p in pd.planes if p.name == "/host:CPU"]
    out = []
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                if st.get("hlo_module") == module and "hlo_op" in st:
                    out.append((st["hlo_op"], ev.name, ev.start_ns,
                                ev.duration_ns))
    return out


def device_planes(trace_dir: str) -> dict:
    """{device plane name: [(kernel_name, start_ns, duration_ns)]} of
    every kernel and copy on the CUDA stream lines of the newest trace
    under `trace_dir`."""
    pd = _newest_profile(trace_dir)
    out = {}
    for plane in pd.planes:
        if plane.name.startswith("/device:"):
            out[plane.name] = [(ev.name, ev.start_ns, ev.duration_ns)
                               for line in plane.lines
                               if line.name.startswith("Stream")
                               for ev in line.events]
    return out


def _busy_ns(spans) -> float:
    """Length of the union of (start, end) spans."""
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def collective_table(planes: dict, nsteps: int) -> dict:
    """Per device, per step: kernel launches, NCCL kernels (by name) and
    their device ms, device busy ms and the traced span in ms.  An NCCL
    kernel's time includes waiting for its peers."""
    rows = {}
    for name, evs in sorted(planes.items()):
        nccl = [(s, s + d) for k, s, d in evs if "nccl" in k.lower()]
        spans = [(s, s + d) for _, s, d in evs]
        span = (max(e for _, e in spans) - min(s for s, _ in spans)
                if spans else 0.0)
        rows[name] = {
            "launches": len(evs) / nsteps,
            "collectives": len(nccl) / nsteps,
            "collective_ms": sum(e - s for s, e in nccl) / 1e6 / nsteps,
            "busy_ms": _busy_ns(spans) / 1e6 / nsteps,
            "span_ms": span / 1e6 / nsteps}
    return rows


def stage_table(info: dict, events, nsteps: int) -> dict:
    """Per-stage sums per step: device_ms, launches, MB (bytes/1e6),
    plus a "vsolve" row (the share of those stages spent in vertical
    solves), a "total" row and the device busy time.

    Kernels replayed from a CUDA graph carry hlo_op "command_buffer";
    they are matched by kernel name instead (XLA names a kernel after
    its fusion, "." becoming "_").  XLA reuses one kernel for identical
    fusions under the first one's name, so that match can credit a
    kernel to the stage of its first user; run with
    --xla_gpu_enable_command_buffer= for exact attribution."""
    rows = defaultdict(lambda: {"device_ms": 0.0, "launches": 0.0,
                                "MB": 0.0})
    for name, d in info.items():
        mb = d["bytes"] * d["count"] / nsteps / 1e6
        rows[d["stage"]]["MB"] += mb
        rows["total"]["MB"] += mb
        if d["vsolve"]:
            rows[VSOLVE]["MB"] += mb
    by_kernel = {name.replace(".", "_"): name for name in info}
    unmatched = 0
    for hlo_op, kernel, _, dur in events:
        d = info.get(hlo_op) or info.get(by_kernel.get(kernel))
        stage, vs = (d["stage"], d["vsolve"]) if d else (OTHER, False)
        unmatched += d is None
        keys = [stage, "total"] + ([VSOLVE] if vs else [])
        for k in keys:
            rows[k]["device_ms"] += dur / 1e6 / nsteps
            rows[k]["launches"] += 1.0 / nsteps
    spans = sorted((s, s + d) for _, _, s, d in events)
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return {"rows": dict(rows), "unmatched_events": unmatched,
            "busy_ms_per_step": _busy_ns(spans) / 1e6 / nsteps,
            "span_ms_per_step": window / 1e6 / nsteps}


def format_table(table: dict) -> str:
    order = [s for s in STAGES + (OTHER,) if s in table["rows"]]
    lines = ["| stage | device ms/step | launches/step | "
             "modelled HLO MB/step (not DRAM traffic) |",
             "|---|---|---|---|"]
    for k in order + [VSOLVE, "total"]:
        r = table["rows"].get(k)
        if r is None:
            continue
        label = "(of which vertical solves)" if k == VSOLVE else k
        lines.append(f"| {label} | {r['device_ms']:.4f} | "
                     f"{r['launches']:.1f} | {r['MB']:.2f} |")
    return "\n".join(lines)
