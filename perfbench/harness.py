"""One run of one cell: inputs from the seed, warm-up, the measured (or
traced) window of steps in a closed loop, then the check of the steps kept
from the window against the plain reference.

The program under test is the one the configuration names
(``perfbench/programs/<name>.py``), with the geometry it shares with its
reference.  The steps kept for the check are the window's first, whose
input the harness made from the seed, and ``kept_steps`` more drawn from
the seed over the rest of the window (reservoir sampling), each with one
packet drawn from the seed; their inputs, inverse outputs and direct
outputs are copied into buffers allocated at set-up, so what is kept never
changes what the window allocates.
"""

from __future__ import annotations

import dataclasses
import random
import time

import torch

from . import spec, tracing, work


class Control:
    """The reference in the program's place, in float32 with TF32
    operands: the control that the limits must fail."""

    def __init__(self, geo, traffic, device):
        self.ref = geo.reference(device, torch.float32, tf32_operands=True)
        self.scders, self.uvders = traffic.scders, traffic.uvders

    def inv(self, vor, div, sc):
        return self.ref.inv(vor, div, sc, self.scders, self.uvders)

    def dir(self, u, v, sc):
        return self.ref.dir(u, v, sc)

    def close(self):
        self.ref = None


class Sampler:
    """Which steps and packets are kept: slot 0 for the first step, slots
    1..kept by reservoir sampling over the later ones, all from the seed."""

    def __init__(self, seed: int, kept: int, npackets: int):
        self.rng = random.Random(seed)
        self.kept = kept
        self.np = npackets

    def choose(self, step: int):
        if step == 0:
            return 0, self.rng.randrange(self.np)
        j = step - 1
        if j < self.kept:
            slot = 1 + j
        else:
            r = self.rng.randrange(j + 1)
            if r >= self.kept:
                return None
            slot = 1 + r
        return slot, self.rng.randrange(self.np)


class Runner:
    """The closed loop of steps, the grid-point update, and the buffers of
    the kept steps."""

    def __init__(self, traffic, geo, program, device, dtype):
        self.t = traffic
        self.geo = geo
        self.prog = program
        self.device = device
        self.dtype = dtype
        self.packets = traffic.packets()
        self.rows = [self._rows(p) for p in self.packets]
        order = torch.as_tensor([r for p in self.packets for r in p.sc_rows])
        self.perm = (None if torch.equal(order, torch.arange(traffic.nsc))
                     else torch.argsort(order).to(device))
        self.valid = geo.valid_points(device)
        n = 1 + traffic.kept_steps
        s2 = geo.nspec2
        nuv = max(p.nuv for p in self.packets)
        nsc = max(p.nsc for p in self.packets)
        nout = max(traffic.outputs(p) for p in self.packets)

        def buf(*shape):
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(n)]

        self.keep = dict(vor=buf(nuv, s2), div=buf(nuv, s2), sc=buf(nsc, s2),
                         grid=buf(nout, geo.ngptot), ovor=buf(nuv, s2),
                         odiv=buf(nuv, s2), osc=buf(nsc, s2))
        self.kept = [None] * n          # (step, packet index) of each slot
        self.update = None              # (scalars, winds, signs)

    def held_bytes(self) -> int:
        """Device bytes that the harness itself holds for the whole run:
        the kept steps' buffers, the index tensors, the update."""
        ts = [t for b in self.keep.values() for t in b]
        ts += [self.valid] + ([self.perm] if self.perm is not None else [])
        ts += list(self.update or ())
        return sum(t.numel() * t.element_size() for t in ts)

    def _rows(self, p):
        r = list(p.sc_rows)
        if r == list(range(r[0], r[0] + len(r))):
            return slice(r[0], r[0] + len(r))
        return torch.as_tensor(r, device=self.device)

    def inputs(self, seed: int):
        """The step's input spectra from the seed, on the device in the
        working dtype: standard normal coefficients, with the imaginary
        parts of m = 0 and the global mean set to zero; and from the same
        seed the grid-point update (the geometry's fields times the
        traffic's ``grid_update``, and a sign for each field of a call)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed % 2 ** 64)
        t = self.t
        x = torch.randn((2 * t.nuv + t.nsc, self.geo.nspec2), generator=g,
                        device=self.device, dtype=self.dtype)
        self.geo.constrain(x)
        nf = max(2 * p.nuv + p.nsc for p in self.packets)
        sc, wind = self.geo.grid_update(g, self.device, self.dtype)
        signs = torch.randint(0, 2, (nf, 1, 1), generator=g,
                              device=self.device).to(self.dtype) * 2 - 1
        self.update = (sc * t.grid_update, wind * t.grid_update, signs)
        return (x[: t.nuv], x[t.nuv: 2 * t.nuv], x[2 * t.nuv:]) \
            if t.nuv else (None, None, x)

    def apply_update(self, grid, p, step: int) -> None:
        """Adds the grid-point update in place to the u, v and scalar
        fields of a packet's inverse output, with the opposite sign on odd
        steps."""
        if not self.t.grid_update:
            return
        sc, wind, signs = (u.to(grid.dtype) for u in self.update)
        sign = -1.0 if step % 2 else 1.0
        m2, n = 2 * p.nuv, p.nsc
        if m2:
            grid[:m2].addcmul_(signs[:m2], wind, value=sign)
        grid[m2: m2 + n].addcmul_(signs[m2: m2 + n], sc, value=sign)

    def _store_in(self, slot, step, k, pv, pd, psc, grid):
        p = self.packets[k]
        kb = self.keep
        if p.nuv:
            kb["vor"][slot][: p.nuv].copy_(pv)
            kb["div"][slot][: p.nuv].copy_(pd)
        kb["sc"][slot][: p.nsc].copy_(psc)
        nout = self.t.outputs(p)
        if grid.shape[0] != nout:
            raise ValueError(f"the inverse gave {grid.shape[0]} fields, "
                             f"not {nout}")
        torch.index_select(grid.reshape(nout, -1), 1, self.valid,
                           out=kb["grid"][slot][:nout])
        self.kept[slot] = (step, k)

    def _store_out(self, slot, k, out):
        p = self.packets[k]
        kb = self.keep
        if p.nuv:
            kb["ovor"][slot][: p.nuv].copy_(out[0])
            kb["odiv"][slot][: p.nuv].copy_(out[1])
        kb["osc"][slot][: p.nsc].copy_(out[2])

    def step(self, state, step: int, hold=None):
        """One step from ``state``; returns the next state.  ``hold``:
        (slot, packet index) to keep."""
        vor, div, sc = state
        prog = self.prog
        outs = []
        for k, (p, rows) in enumerate(zip(self.packets, self.rows)):
            pv = vor[p.lo: p.hi] if p.nuv else None
            pd = div[p.lo: p.hi] if p.nuv else None
            psc = sc[rows]
            g = prog.inv(pv, pd, psc)
            keep = hold is not None and hold[1] == k
            if keep:
                self._store_in(hold[0], step, k, pv, pd, psc, g)
            self.apply_update(g, p, step)
            m, n = p.nuv, p.nsc
            out = prog.dir(g[:m] if m else None, g[m: 2 * m] if m else None,
                           g[2 * m: 2 * m + n])
            if keep:
                self._store_out(hold[0], k, out)
            outs.append(out)
        if len(outs) == 1:
            return outs[0]
        nv = torch.cat([o[0] for o in outs]) if self.t.nuv else None
        nd = torch.cat([o[1] for o in outs]) if self.t.nuv else None
        ns = torch.cat([o[2] for o in outs])
        return nv, nd, (ns if self.perm is None else ns[self.perm])

    def loop(self, state, sampler, seconds=None, steps=None, sync=None):
        """Steps in a closed loop, each timed from the host clock to the
        device's end of it, until ``seconds`` have passed or ``steps``
        are done; returns (state, step times, window seconds)."""
        times = []
        t_start = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            state = self.step(state, i, sampler.choose(i))
            sync()
            t1 = time.perf_counter()
            times.append(t1 - t0)
            i += 1
            if (steps is not None and i >= steps) or \
                    (seconds is not None and t1 - t_start >= seconds):
                return state, times, t1 - t_start


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap over the largest |want|."""
    scale = want.abs().max().item()
    gap = (got.double() - want).abs().max().item()
    return gap / scale if scale > 0 else float("inf") if gap else 0.0


def check(runner, ref) -> dict:
    """name -> (reading, slot readings) of each compared number over the
    kept steps: the widest gap of each output family against the
    reference, over that family's largest value.  The direct outputs are
    compared with the reference's direct transform of its own inverse
    output with the step's update added."""
    t = runner.t
    kb = runner.keep
    out = {}
    for slot, kept in enumerate(runner.kept):
        if kept is None:
            continue
        p = runner.packets[kept[1]]
        m, n = p.nuv, p.nsc
        vor = kb["vor"][slot][:m] if m else None
        div = kb["div"][slot][:m] if m else None
        g = ref.inv(vor, div, kb["sc"][slot][:n], t.scders, t.uvders)
        nout = g.shape[0]
        got = kb["grid"][slot][:nout]
        want = g.reshape(nout, -1)[:, runner.valid]
        read = {}
        for name, a, b in t.families(p):
            read[name] = max_rel(got[a:b], want[a:b])
        del want
        runner.apply_update(g, p, kept[0])
        rv, rd, rs = ref.dir(g[:m] if m else None, g[m: 2 * m] if m else None,
                             g[2 * m: 2 * m + n])
        del g
        if m:
            read["dir.vordiv"] = max_rel(
                torch.cat([kb["ovor"][slot][:m], kb["odiv"][slot][:m]]),
                torch.cat([rv, rd]))
        read["dir.sc"] = max_rel(kb["osc"][slot][:n], rs)
        for k, v in read.items():
            out.setdefault(k, []).append(v)
    return {k: (max(v), v) for k, v in out.items()}


@dataclasses.dataclass
class Record:
    """An untraced window, as the end-to-end readers read it."""

    times: list
    window_s: float
    steps: int
    peak_bytes: int         # the allocator's peak less what the harness holds
    setup_s: float


def _sync(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: torch.device, program=None, say=None) -> dict:
    """One run; returns the result line as a dict."""
    import sys

    say = say or (lambda s: print(s, file=sys.stderr))
    config, traffic = cell.config, cell.traffic
    mod = spec.program(config["program"])
    geo = mod.geometry(config)
    dtype = getattr(torch, config["dtype"])
    prog = program(geo, traffic, device) if program else \
        mod.Program(config, traffic)
    runner = Runner(traffic, geo, prog, device, dtype)
    sync = _sync(device)
    state0 = runner.inputs(seed)
    held = runner.held_bytes()
    for i in range(traffic.warmup_steps):
        runner.step(state0, i, (0, i % len(runner.packets)))
    runner.kept = [None] * len(runner.kept)
    sync()
    setup_s = time.perf_counter() - t0
    sampler = Sampler(seed, traffic.kept_steps, len(runner.packets))
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    dev = dict(platform="gpu" if device.type == "cuda" else "cpu",
               kind=kind, count=cell.chips)
    metrics, breakdown = {}, None
    if not trace:
        state, times, wall = runner.loop(state0, sampler, seconds=seconds,
                                         sync=sync)
        dev["memory_peak_bytes"] = _peak(device)
        rec = Record(times, wall, len(times),
                     max(dev["memory_peak_bytes"] - held, 0), setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = (spec.reader(m["name"]).read(rec), m["unit"])
        steps = len(times)
        ms = sorted(x * 1e3 for x in times)
        say(f"perfbench: {steps} steps in {wall:.3f} s; step ms first "
            f"{times[0] * 1e3:.3f}, min {ms[0]:.3f}, median "
            f"{ms[len(ms) // 2]:.3f}, max {ms[-1]:.3f}; set-up "
            f"{setup_s:.3f} s; peak {dev['memory_peak_bytes']} bytes, of "
            f"which the harness holds {held}")
    else:
        readers = {m["name"]: spec.reader(m["name"]) for m in cell.per_layer}
        spans = tracing.merge_spans(readers.values())
        try:
            peak = work.peaks(kind)
        except KeyError as e:
            say(f"perfbench: {e.args[0]}; the roofline shares are left out")
            peak = None
        steps = traffic.trace_steps
        ctx = dict(geo=geo, calls=traffic.calls(), scders=traffic.scders,
                   uvders=traffic.uvders, itemsize=dtype.itemsize, peak=peak)
        box = {}

        def go():
            box["state"] = runner.loop(state0, sampler, steps=steps,
                                       sync=sync)[0]

        summ = tracing.profile(go, spans, steps, ctx, say)
        state = box.pop("state")
        dev["memory_peak_bytes"] = _peak(device)
        dev["busy_s"] = summ.busy_s
        dev["window_s"] = summ.window_s
        for m in cell.per_layer:
            r = readers[m["name"]]
            if summ.broken & set(getattr(r, "SPANS", {})):
                continue
            metrics[m["name"]] = (r.read(summ), m["unit"])
        breakdown = dict(device_ops=summ.device_ops, idle_gaps=summ.idle_gaps)
        say(f"perfbench: traced {steps} steps, {summ.launches} launches, "
            f"{summ.unmatched} device activities without a launch")
    del state, state0
    prog.close()
    runner.prog = prog = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(runner, geo.reference(device))
    checks, failed_slots = {}, set()
    correct = True
    for name, (value, per_slot) in numbers.items():
        limit = cell.limits.get(name)
        ok = limit is not None and value <= limit
        correct &= ok
        for s, v in enumerate(per_slot):
            if limit is None or v > limit:
                failed_slots.add(s)
        checks[name] = dict(value=value, limit=limit)
    result = dict(correct=bool(correct), attempted=steps,
                  failed=len(failed_slots),
                  metrics={k: dict(value=v, unit=u)
                           for k, (v, u) in metrics.items() if v is not None},
                  device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
