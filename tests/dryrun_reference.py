"""What the dry-run tests read from the reference's compiled HLO, and the
JAX subprocess they read it in.

``costs`` runs inside the JAX subprocess (``repro.launch.dryrun`` forces
512 host devices at import, so JAX never runs in the test process); the
subprocess finds this module on its ``PYTHONPATH``.
"""
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMP = re.compile(r"^(?:ENTRY )?%([\w.\-]+) .*\{$")
DEF = re.compile(r"^\s*(?:ROOT )?%([\w.\-]+) = [a-z0-9]+\[([0-9,]*)\]")
INST = re.compile(r"^\s*(?:ROOT )?%([\w.\-]+) = (.*)$")
ARRAY = re.compile(r"\b([a-z][a-z0-9]*)\[([0-9,]*)\]")
ELEMENT = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
           "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
           "f64": 8, "c64": 8, "c128": 16}
# instructions XLA's cost analysis counts no bytes for
UNMOVED = {"parameter", "constant", "get-tuple-element", "tuple", "bitcast"}
# the chunked attention's two scans (src/repro/models/layers.py): a loop the
# compile keeps by its line, the kv scan's at 177 and the query scan's at
# 184; a scan of one block, which XLA unrolls, by its body's function
SCANS = ("repro/models/layers.py", (177, 184),
         "chunked_attention.<locals>.q_step")
QUANTIZER = "repro/kernels/fixedpoint.py"
# what a fusion that only converts between bf16 and float32 may otherwise
# do (see accessed), and each element's bytes in a bf16 run
MOVES = {"bitcast", "copy", "transpose", "reshape", "broadcast", "slice",
         "dynamic-slice", "dynamic-update-slice", "concatenate", "parameter",
         "constant", "tuple", "get-tuple-element"}
AS_BF16 = dict(ELEMENT, f32=2)


def costs(hlo, loops=False):
    """``(flops, moved, accessed)`` of an optimized HLO module: the dots'
    FLOPs (2 x result x contraction), the collectives' bytes by kind
    (``parse_collective_bytes``, a line at a time) and :func:`accessed`'s
    bytes, each computation counted as often as it runs: a while body its
    known trip count (``cost_analysis`` and ``parse_collective_bytes``
    count it once, which the reference's dry run extrapolates around).
    With ``loops``, only what runs inside a while body (in a one-period
    probe, the chunked attention's scans)."""
    from repro.launch.analysis import _COLLECTIVES, parse_collective_bytes
    comps, shapes, entry, cur = {}, {}, None, None
    for line in hlo.splitlines():
        m = COMP.match(line)
        if m:
            cur = m.group(1)
            comps[cur] = []
            entry = cur if line.startswith("ENTRY") else entry
            continue
        if cur is not None:
            comps[cur].append(line)
        d = DEF.match(line)
        if d:
            shapes[d.group(1)] = [int(x) for x in d.group(2).split(",") if x]

    def count(c, looped=False):
        flops, moved = 0, dict.fromkeys(_COLLECTIVES, 0.0)
        counted = looped or not loops
        for line in comps[c]:
            if counted and " dot(" in line:
                lhs = shapes[re.search(r" dot\(%([\w.\-]+)", line).group(1)]
                dims = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", line)
                k = int(np.prod([lhs[int(x)] for x in dims.group(1).split(",")
                                 if x]))
                flops += 2 * int(np.prod(shapes[DEF.match(line).group(1)])) * k
            if counted:
                per_op = parse_collective_bytes(line)["per_op_bytes"]
                for kind, b in per_op.items():
                    moved[kind] += b
            trips = re.search(r'"known_trip_count":\{"n":"(\d+)"', line)
            for how, callee in re.findall(r"(calls|body)=%([\w.\-]+)", line):
                n = int(trips.group(1)) if how == "body" else 1
                f, b = count(callee, looped or how == "body")
                flops += n * f
                for kind in moved:
                    moved[kind] += n * b[kind]
        return flops, moved
    return count(entry) + (accessed(hlo, loops),)


def _array_bytes(shape, element=None):
    """The bytes of an HLO shape's arrays (a tuple's elements summed), each
    element as ``element`` (default :data:`ELEMENT`) sizes its type."""
    element = element or ELEMENT
    return sum(element.get(t, 0) * math.prod(int(x) for x in dims.split(",")
                                             if x)
               for t, dims in ARRAY.findall(shape))


def _instructions(hlo):
    """``({computation: [(name, shape, opcode, operands, rest)]}, {name:
    shape}, entry)``: each instruction of an HLO module, its result's shape
    and what follows its operands (attributes, metadata)."""
    comps, shapes, entry, cur = {}, {}, None, None
    for line in hlo.splitlines():
        m = COMP.match(line)
        if m:
            cur = m.group(1)
            comps[cur] = []
            entry = cur if line.startswith("ENTRY") else entry
            continue
        i = INST.match(line)
        if i is None or cur is None:
            continue
        text, depth = i.group(2), 0
        if text.startswith("("):            # a tuple's shape
            for end, ch in enumerate(text):
                depth += (ch == "(") - (ch == ")")
                if depth == 0:
                    break
            shape, text = text[:end + 1], text[end + 1:].lstrip()
        else:
            shape, _, text = text.partition(" ")
        op = re.match(r"([a-z\-]+)\(", text)
        depth = 1
        for end in range(op.end(), len(text)):
            depth += (text[end] == "(") - (text[end] == ")")
            if depth == 0:
                break
        shapes[i.group(1)] = shape
        comps[cur].append((i.group(1), shape, op.group(1), re.findall(
            r"%([\w.\-]+)", text[op.end():end]), text[end:]))
    return comps, shapes, entry


def _sites(hlo):
    """``site(opcode, rest)``: the part of the step the module's stack
    frames place an instruction in: ``"scans"`` where a frame of its stack
    is in the chunked attention's scans (:data:`SCANS`: at one of their
    lines, or in their body), ``"quantizer"`` for a while loop whose own
    frame is in :data:`QUANTIZER` (the Pallas quantizer the CPU runs as a
    loop over its grid, as :func:`collectives` places it), else ``None``."""
    files, locs, frames, names = (_section(hlo, n) for n in (
        "FileNames", "FileLocations", "StackFrames", "FunctionNames"))
    path, lines, body = SCANS

    def where(i):
        loc = locs[int(re.search(r"file_location_id=(\d+)",
                                 frames[i]).group(1))]
        file_ = files[int(re.search(r"file_name_id=(\d+)", loc).group(1))]
        fn = names[int(re.search(r"function_name_id=(\d+)", loc).group(1))]
        return (file_.strip('"'), int(re.search(r"\bline=(\d+)",
                                                loc).group(1)), fn.strip('"'))

    @functools.lru_cache(maxsize=None)
    def in_scans(i):
        file_, line, fn = where(i)
        parent = int(re.search(r"parent_frame_id=(\d+)", frames[i]).group(1))
        return (file_.endswith(path) and (line in lines
                                          or fn.startswith(body))) \
            or (parent != i and parent in frames and in_scans(parent))

    def site(op, rest):
        i = re.search(r"stack_frame_id=(\d+)", rest)
        if i is None:
            return None
        if in_scans(int(i.group(1))):
            return "scans"
        if op == "while" and where(int(i.group(1)))[0].endswith(QUANTIZER):
            return "quantizer"
        return None
    return site


def accessed(hlo, loops=False, once=False):
    """The bytes an optimized HLO module reads and writes, counted as XLA's
    cost analysis counts them (``cost_analysis()["bytes accessed"]``):
    ``"all"``, and of those ``"scans"`` and ``"quantizer"``, the parts
    :func:`_sites` places there; ``"conversions"``, those of the
    instructions that only convert between bf16 and float32 (a ``convert``,
    or a fusion of converts and of :data:`MOVES`: the CPU compile's, which
    runs the bf16 models in float32); ``"bf16_all"``, ``"bf16_scans"`` and
    ``"bf16_quantizer"``, the same as the program moves them in bf16: each
    float32 element 2 bytes (:data:`AS_BF16`), the conversions none.

    Each instruction outside a fusion reads its operands and writes its
    result, but those of :data:`UNMOVED`; a fusion writes its result (only
    the update of a ``dynamic-update-slice`` root, in place) and reads each
    parameter once, only the slice where a slice or ``dynamic-slice`` reads
    it, nothing where it is a ``dynamic-update-slice``'s destination; a
    ``call`` counts its computation once, a ``while`` its body and
    condition its known trip count times (once with ``once``, as
    ``cost_analysis`` counts it). With ``loops``, only what runs inside a
    while body."""
    comps, shapes, entry = _instructions(hlo)
    site = _sites(hlo)

    def read(c, p, element):    # a fusion's parameter p
        n, shared = 0, False
        for _, shape, op, args, _ in comps[c]:
            if p not in args:
                continue
            if op == "slice" or (op == "dynamic-slice" and args[0] == p):
                n += _array_bytes(shape, element)
            elif op == "dynamic-update-slice" and args[0] == p:
                pass                        # written in place
            elif op in ("dynamic-slice", "dynamic-update-slice",
                        "broadcast", "reshape"):
                n += _array_bytes(shapes[p], element)
            elif not shared:                # one read the others share
                n, shared = n + _array_bytes(shapes[p], element), True
        return n

    def moved(shape, op, args, rest, element):
        if op != "fusion":
            return _array_bytes(shape, element) + sum(
                _array_bytes(shapes[a], element) for a in args)
        c = re.search(r"calls=%([\w.\-]+)", rest).group(1)
        made = {i[0]: i for i in comps[c]}
        root = comps[c][-1]             # a computation's last line
        outs = [made[a] for a in root[3]] if root[2] == "tuple" else [root]
        return sum(_array_bytes(shapes[o[3][1]], element)
                   if o[2] == "dynamic-update-slice"
                   else _array_bytes(o[1], element) for o in outs) \
            + sum(read(c, i[0], element) for i in comps[c]
                  if i[2] == "parameter")

    def conversion(inst):
        body = [inst]
        if inst[2] == "fusion":
            body = comps[re.search(r"calls=%([\w.\-]+)", inst[4]).group(1)]
            if any(i[2] not in MOVES and i[2] != "convert" for i in body):
                return False
        return any(i[2] == "convert" and {shapes[i[3][0]].split("[")[0],
                                          i[1].split("[")[0]}
                   == {"bf16", "f32"} for i in body)

    def walk(c, looped, part):
        out = Counter()
        for inst in comps[c]:
            _, shape, op, args, rest = inst
            if op in UNMOVED:
                continue
            here = part or site(op, rest)
            if op in ("while", "call"):
                trips = re.search(r'"known_trip_count":\{"n":"(\d+)"', rest)
                n = int(trips.group(1)) if trips and not once else 1
                for callee in re.findall(
                        r"(?:body|condition|to_apply)=%([\w.\-]+)", rest):
                    for k, v in walk(callee, looped or op == "while",
                                     here).items():
                        out[k] += n * v
            elif looped or not loops:
                b = moved(shape, op, args, rest, ELEMENT)
                converts = conversion(inst)
                half = 0 if converts else moved(shape, op, args, rest,
                                                AS_BF16)
                out["all"] += b
                out["bf16_all"] += half
                out["conversions"] += b if converts else 0
                if here:
                    out[here] += b
                    out["bf16_" + here] += half
        return out
    out = walk(entry, False, None)
    return {k: out[k] for k in (
        "all", "scans", "quantizer", "conversions", "bf16_all", "bf16_scans",
        "bf16_quantizer")}


def bf16_dots(hlo):
    """How many dots of an HLO module read a bf16 operand."""
    comps, shapes, _ = _instructions(hlo)
    return sum(i[2] == "dot" and any(shapes[a].startswith("bf16[")
                                     for a in i[3])
               for c in comps.values() for i in c)


def held_bytes(want, finding=()):
    """The reference's bytes a step's port bytes are held to: its compiled
    bytes (``want["accessed"]``, :func:`accessed`'s, with ``bf16_dots``
    from the same module) outside the chunked attention's scans, and
    outside the quantizer's loops under ``quantizer_gathers``. Under the
    ``float32`` finding, which this asserts on the module (no dot reads a
    bf16 operand: its CPU compile runs the bf16 model's products, and the
    values around them, in float32; and its conversions between bf16 and
    float32 move bytes), the same as the program moves them in bf16."""
    acc = want["accessed"]
    width = ""
    if "float32" in finding:
        assert want["bf16_dots"] == 0 and acc["conversions"] > 0, \
            (want["bf16_dots"], acc)
        width = "bf16_"
    out = acc[width + "all"] - acc[width + "scans"]
    if "quantizer_gathers" in finding:
        assert acc["quantizer"] > 0, acc
        out -= acc[width + "quantizer"]
    return out


def _section(hlo, name):
    """``{id: text}`` of one of the module's trailing tables (``FileNames``,
    ``FileLocations``, ``StackFrames``)."""
    out, on = {}, False
    for line in hlo.splitlines():
        if line == name:
            on = True
            continue
        if on:
            m = re.match(r"^(\d+) (.*)$", line)
            if m:
                out[int(m.group(1))] = m.group(2)
            elif out:
                break
    return out


def _computations(hlo):
    """``({name: lines}, entry)``: each computation of an HLO module."""
    comps, entry, cur = {}, None, None
    for line in hlo.splitlines():
        m = COMP.match(line)
        if m:
            cur = m.group(1)
            comps[cur] = []
            entry = cur if line.startswith("ENTRY") else entry
        elif cur is not None:
            comps[cur].append(line)
    return comps, entry


def collectives(hlo):
    """Every collective of an optimized HLO module as the step runs it:
    ``[kind, bytes, dtype, elements, times, loop, site]``, ``bytes`` its
    result's bytes times ``times``, the trip counts of the while loops
    around it, ``loop`` the file the module's stack frames place the
    innermost of those loops' op in (``""`` outside every loop: a Pallas
    kernel that the CPU runs as a loop over its grid is its kernel's
    file) and ``site`` the file they place the collective itself in."""
    from repro.launch.analysis import parse_collective_bytes
    files, locs, frames = (_section(hlo, n) for n in (
        "FileNames", "FileLocations", "StackFrames"))

    def file_of(line):
        frame = re.search(r"stack_frame_id=(\d+)", line)
        if frame is None:
            return ""
        loc = re.search(r"file_location_id=(\d+)",
                        frames[int(frame.group(1))]).group(1)
        name = re.search(r"file_name_id=(\d+)", locs[int(loc)]).group(1)
        return files[int(name)].strip('"')

    comps, entry = _computations(hlo)

    def walk(c, times, loop):
        out = []
        for line in comps[c]:
            for kind, b in parse_collective_bytes(line)["per_op_bytes"]\
                    .items():
                if b:       # a tuple's first element
                    dtype, dims = re.search(r"= \(?([a-z0-9]+)\[([0-9,]*)\]",
                                            line).groups()
                    out.append([kind, b * times, dtype, int(np.prod(
                        [int(x) for x in dims.split(",") if x])), times,
                        loop, file_of(line)])
            trips = re.search(r'"known_trip_count":\{"n":"(\d+)"', line)
            for how, callee in re.findall(r"(calls|body)=%([\w.\-]+)",
                                          line):
                out += walk(callee, times * int(trips.group(1)), file_of(
                    line)) if how == "body" else walk(callee, times, loop)
        return out
    return walk(entry, 1, "")


def _first_group(line):
    """The device ids of a collective's first replica group (``None``
    where it names none)."""
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]"
                  r"(?:T\(([\d,]+)\))?", line)
    if m:
        dims = [int(x) for x in m.group(3).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            ids = ids.transpose([int(x) for x in m.group(4).split(",")])
        return ids.reshape(int(m.group(1)), int(m.group(2)))[0].tolist()
    m = re.search(r"replica_groups=\{\{([\d,]+)\}", line)
    return [int(x) for x in m.group(1).split(",")] if m else None


def _moe_lines(hlo, func):
    """A function of a stack frame id: the line of ``func`` in the
    reference's ``src/repro/models/moe.py`` that the frame or one of its
    parents names, stripped (``None`` where none does)."""
    files, locs, frames = (_section(hlo, n) for n in (
        "FileNames", "FileLocations", "StackFrames"))
    funcs = _section(hlo, "FunctionNames")
    with open(os.path.join(ROOT, "src", "repro", "models", "moe.py")) as f:
        source = f.read().splitlines()

    def line_of(frame):
        seen = set()
        while frame not in seen:
            seen.add(frame)
            loc = locs[int(re.search(r"file_location_id=(\d+)",
                                     frames[frame]).group(1))]
            name = files[int(re.search(r"file_name_id=(\d+)", loc)
                             .group(1))]
            fn = funcs[int(re.search(r"function_name_id=(\d+)", loc)
                           .group(1))]
            if name.endswith('repro/models/moe.py"') and fn == f'"{func}"':
                return source[int(re.search(r"line=(\d+)", loc)
                                  .group(1)) - 1].strip()
            frame = int(re.search(r"parent_frame_id=(\d+)",
                                  frames[frame]).group(1))
        return None
    return line_of


def _moe_ops(hlo, func, kinds):
    """``[kind, arrays, line, group]`` of each instruction of ``kinds`` in
    an optimized HLO module whose stack frames name ``func`` of the
    reference's ``moe.py``: ``arrays`` its result's ``[dtype, dims]`` (each
    element of a tuple), ``line`` the source line, ``group`` its first
    replica group (``None`` where it names none)."""
    line_of = _moe_lines(hlo, func)
    out = []
    for line in hlo.splitlines():
        m = re.match(r"^\s*(?:ROOT )?%[\w.\-]+ = (.*?) ([a-z\-]+)\(", line)
        frame = re.search(r"stack_frame_id=(\d+)", line)
        if not m or frame is None or m.group(2) not in kinds:
            continue
        where = line_of(int(frame.group(1)))
        if where is None:
            continue
        arrays = [[t, [int(x) for x in dims.split(",") if x]]
                  for t, dims in ARRAY.findall(m.group(1))]
        out.append([m.group(2), arrays, where, _first_group(line)])
    return out


def dense_combine(hlo):
    """The collectives of the reference's dense MoE route
    (``src/repro/models/moe.py``, ``_moe_dense``) in an optimized HLO
    module of the (16, 16) (data, model) mesh:
    ``[kind, arrays, axis, source]`` each, ``arrays`` the result's
    ``[dtype, dims]`` (every element of a combined all-reduce's tuple),
    ``axis`` ``"data"``, ``"model"`` or ``"both"`` by its first replica
    group, ``source`` the line of ``_moe_dense`` its stack frames name,
    stripped (XLA gives a combined all-reduce the frames of its first
    operand)."""
    out = []
    for kind, arrays, where, group in _moe_ops(hlo, "_moe_dense", (
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute")):
        group = group or [0]
        rows = {i // 16 for i in group}
        cols = {i % 16 for i in group}
        axis = "model" if len(rows) == 1 else "data" if len(cols) == 1 \
            else "both"
        out.append([kind, arrays, axis, where])
    return out


def router_layout(hlo):
    """How the reference lays out its router's top-k gradient and the
    normalisation of the routing weights (``_route``'s ``lax.top_k`` and
    ``top_w / ...`` lines): ``[kind, dims]`` of each ``scatter`` (top-k's
    gradient into zeros) and ``divide`` of those lines, in the module's
    order, and the dims of every collective they issue."""
    ops = _moe_ops(hlo, "_route", ("scatter", "divide", "all-reduce",
                                   "all-gather", "reduce-scatter",
                                   "all-to-all"))
    lines = ("top_w, top_e = lax.top_k(", "top_w = top_w / ")
    return [[kind, arrays[0][1]] for kind, arrays, where, _ in ops
            if where.startswith(lines)]


def new_caches(hlo):
    """The shapes of the float32 values of a decode step that are its
    caches' ``dynamic_update_slice``, one a time the step computes them:
    in its entry computation, and in a while body its trip count times
    (the reference's decode scans its layer periods, a loop where a step
    has more than one). They are the step's new K and V, written anew in
    float32 before the bfloat16 outputs (so temporaries of the step)."""
    comps, entry = _computations(hlo)

    def walk(c, times):
        out = []
        for line in comps[c]:
            d = DEF.match(line)
            if d and re.search(r"= f32\[", line) \
                    and 'dynamic_update_slice"' in line:
                out += [[int(x) for x in d.group(2).split(",") if x]] * times
            trips = re.search(r'"known_trip_count":\{"n":"(\d+)"', line)
            for body in re.findall(r"body=%([\w.\-]+)", line):
                out += walk(body, times * int(trips.group(1)))
        return out
    return walk(entry, 1)


def cache_kv(cache):
    """``(local shape, element size)`` of each K and V of a decode step's
    cache of DTensors (rank 0's shares)."""
    return [(list(t.to_local().shape), t.element_size())
            for layer in cache["layers"] for k, t in layer.items()
            if k in ("k", "v")]


def new_cache_bytes(kv, new_caches):
    """The ``new_cache`` finding on a decode step: the reference writes
    its cache anew, in float32 (each of the port's local K and V, ``kv``
    from :func:`cache_kv`, is one of the reference's float32
    ``dynamic_update_slice`` values, ``new_caches`` from
    :func:`new_caches`: temporaries, as its outputs are bfloat16), where
    the port writes the step's slot into its cache in place. Asserts
    that, and returns the bytes of the port's local K and V, which count
    as written anew."""
    shapes = [tuple(s) for s, _ in kv]
    assert not Counter(shapes) - Counter(map(tuple, new_caches)), \
        (shapes, new_caches)
    return sum(math.prod(s) * n for s, n in kv)


def link_bytes(moved):
    """The link bytes of collectives by kind: an all-reduce twice its
    bytes, the others once (``parse_collective_bytes``'s multipliers)."""
    return sum(b * (2 if k == "all-reduce" else 1) for k, b in moved.items())


class JaxRun:
    """``script`` running in a JAX subprocess on the CPU with ``args`` as
    JSON arguments. :meth:`result` waits for it and returns the JSON it
    prints after ``JAX_OUT``; :meth:`case` returns, as soon as it is
    printed, the JSON after a ``JAX_CASE <key>`` line (one line a case,
    flushed as each is ready), so that the caller's own work overlaps the
    rest of the script's."""

    def __init__(self, script, *args, timeout=600):
        path = os.pathsep.join([os.path.join(ROOT, "src"),
                                os.path.dirname(os.path.abspath(__file__)),
                                os.environ.get("PYTHONPATH", "")])
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path)
        self.deadline = time.monotonic() + timeout
        self.lines, self.cases = [], {}
        self.err = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script] + [json.dumps(a) for a in args],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=self.err,
            text=True)
        self.done = threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            if line.startswith("JAX_CASE "):
                key, value = line[len("JAX_CASE "):].split(" ", 1)
                self.cases[key] = json.loads(value)
        self.proc.wait()
        self.done.set()

    def _failed(self):
        self.err.seek(0)
        return "".join(self.lines) + self.err.read()

    def case(self, key):
        while key not in self.cases:
            assert not self.done.is_set(), self._failed()
            assert time.monotonic() < self.deadline, "the JAX run timed out"
            self.done.wait(0.2)
        return self.cases[key]

    def result(self):
        self.done.wait(max(0.0, self.deadline - time.monotonic()))
        line = [ln for ln in self.lines if ln.startswith("JAX_OUT ")]
        assert line, self._failed()
        return json.loads(line[0][len("JAX_OUT "):])

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.done.wait(10)
        self.err.close()


def run_jax(script, *args, timeout=600):
    """:class:`JaxRun`'s result, waited for."""
    run = JaxRun(script, *args, timeout=timeout)
    try:
        return run.result()
    finally:
        run.close()
