"""What the dry-run tests read from the reference's compiled HLO, and the
JAX subprocess they read it in.

``costs`` runs inside the JAX subprocess (``repro.launch.dryrun`` forces
512 host devices at import, so JAX never runs in the test process); the
subprocess finds this module on its ``PYTHONPATH``.
"""
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


def costs(hlo, loops=False):
    """``(flops, moved)`` of an optimized HLO module: the dots' FLOPs (2 x
    result x contraction) and the collectives' bytes by kind
    (``parse_collective_bytes``, a line at a time), each computation
    counted as often as it runs: a while body its known trip count
    (``cost_analysis`` and ``parse_collective_bytes`` count it once, which
    the reference's dry run extrapolates around). With ``loops``, only what
    runs inside a while body (in a one-period probe, the chunked
    attention's scans)."""
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
    return count(entry)


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
