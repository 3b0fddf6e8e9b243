"""Instruction counts of the port's kernels from their SASS, for the
issue-bound floors in PERF.md.

    python3 -m tpudenoise_torch.benchmarks.sass_counts \\
        fused_noise:gauss_blur_kernel mix_noise:mix_noise_kernel [--dump DIR]

Each argument is `<source>:<pattern>`: the script builds `csrc/<source>.cu`
(as the wrappers do; a source that ends in `.so` is taken as a built
library, such as an older tree's), disassembles it with `cuobjdump -sass` and,
for every function whose mangled name holds the pattern, prints its
instruction count, its opcode histogram and its loops.  A loop is a
backward branch: the instructions from its target to the branch, with the
loops nested in it listed under it and the count that leaves them out (a
slow path's loop, such as cosf's large-argument reduction, is nested in
the kernel's main loop but never runs at the main path's arguments), and
the count one pass issues on its fast path (`fast_path`: a predicated
forward branch falls through, but for the innermost one around each
nested loop or CALL, which is taken).  With
--dump, each function's SASS is written to DIR.  The last line is the
results as JSON.  Needs the CUDA toolkit (nvcc, cuobjdump): runs on the
GPU machine.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import os.path as osp
import re
import shutil
import subprocess
import sys

from tpudenoise_torch import cuda_build

_FUNC = re.compile(r'^\s*Function : (\S+)')
_INSN = re.compile(r'/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?'
                   r'([A-Z][A-Z0-9_.]*)([^;]*);')
_TARGET = re.compile(r'0x([0-9a-f]+)')


def _tool(name: str) -> str:
    for cand in (shutil.which(name), f'/usr/local/cuda/bin/{name}'):
        if cand and osp.exists(cand):
            return cand
    raise RuntimeError(f'{name} not found (PATH or /usr/local/cuda/bin)')


def functions(so: str) -> dict:
    """{mangled name: [(address, opcode, operands, line)]} of a library."""
    text = subprocess.run([_tool('cuobjdump'), '-sass', so],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
        elif cur is not None:
            cur.extend(parse(line))
    return out


def parse(text: str) -> list:
    """[(address, opcode, operands, line)] of SASS lines."""
    out = []
    for line in text.splitlines():
        m = _INSN.search(line)
        if m:
            out.append((int(m.group(1), 16), m.group(3), m.group(4).strip(),
                        line.strip()))
    return out


def _demangle(name: str) -> str:
    try:
        return subprocess.run(['c++filt', name], capture_output=True,
                              text=True, timeout=30).stdout.strip() or name
    except (OSError, subprocess.SubprocessError):
        return name


def loops(insns) -> list:
    """Backward branches as (start, end) address ranges, outermost first."""
    found = set()
    for addr, op, args, _ in insns:
        if op.startswith('BRA'):
            t = _TARGET.search(args)
            if t and int(t.group(1), 16) <= addr:
                found.add((int(t.group(1), 16), addr))
    return sorted(found, key=lambda r: (r[0], -r[1]))


def _target(args: str) -> int | None:
    t = _TARGET.search(args)
    return int(t.group(1), 16) if t else None


def fast_path(insns, lo: int, hi: int) -> int:
    """Instructions one pass of the loop [lo, hi] issues on its fast path:
    from lo, a predicated forward branch falls through unless the code it
    skips holds a loop or a CALL (a slow path: taken), an unconditional
    forward branch is followed, and the walk ends at the loop's branch."""
    at = {a: (op, args, line) for a, op, args, line in insns}
    addrs = sorted(at)
    nxt = dict(zip(addrs, addrs[1:]))
    # slow constructs (a nested loop's branch, a CALL) and the predicated
    # forward branches that skip them: for each, the innermost is taken
    slow = [a for a, op, args, _ in insns
            if lo < a < hi and (op.startswith('CALL') or (
                op.startswith('BRA') and (_target(args) or hi) <= a))]
    skips = [(a, _target(args)) for a, op, args, line in insns
             if op.startswith('BRA') and '@' in line.split(op)[0]
             and (_target(args) or 0) > a]
    taken = set()
    for c in slow:
        around = [(t - a, a) for a, t in skips if a < c < t]
        if around:
            taken.add(min(around)[1])
    addr, count = lo, 0
    while addr is not None and lo <= addr <= hi:
        op, args, line = at[addr]
        if op != 'NOP':
            count += 1
        if addr == hi or op == 'EXIT':
            break
        t = _target(args) if op.startswith('BRA') else None
        if t is not None and t > addr and (
                addr in taken or '@' not in line.split(op)[0]):
            addr = t
            continue
        addr = nxt.get(addr)
    return count


def summary(insns) -> dict:
    ops = collections.Counter(op for _, op, _, _ in insns if op != 'NOP')
    out = dict(instructions=sum(ops.values()),
               opcodes=dict(ops.most_common()), loops=[])
    spans = loops(insns)
    for lo, hi in spans:
        body = [i for i in insns if lo <= i[0] <= hi and i[1] != 'NOP']
        inner = [(a, b) for a, b in spans if lo <= a and b <= hi
                 and (a, b) != (lo, hi)]
        outside = [i for i in body
                   if not any(a <= i[0] <= b for a, b in inner)]
        out['loops'].append(dict(
            start=hex(lo), end=hex(hi), instructions=len(body),
            without_nested=len(outside), fast_path=fast_path(insns, lo, hi),
            nested=[(hex(a), hex(b)) for a, b in inner],
            opcodes=dict(collections.Counter(
                i[1] for i in outside).most_common())))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('targets', nargs='+', help='<source>:<pattern>')
    ap.add_argument('--dump', help='write each function\'s SASS here')
    args = ap.parse_args()
    res = {}
    for target in args.targets:
        source, pattern = target.rsplit(':', 1)
        if source.endswith('.so'):
            so = source
        else:
            cuda_build.library(source)
            so = cuda_build.library_path(source)
        for name, insns in functions(so).items():
            if pattern not in name:
                continue
            pretty = _demangle(name)
            res[f'{osp.basename(so)} {pretty}'] = s = summary(insns)
            print(f'{pretty}: {s["instructions"]} instructions; top '
                  f'{list(s["opcodes"].items())[:12]}', flush=True)
            for lp in s['loops']:
                print(f'  loop {lp["start"]}-{lp["end"]}: '
                      f'{lp["instructions"]} instructions, '
                      f'{lp["without_nested"]} outside {len(lp["nested"])} '
                      f'nested loops, {lp["fast_path"]} on the fast path',
                      flush=True)
            if args.dump:
                os.makedirs(args.dump, exist_ok=True)
                safe = re.sub(r'[^A-Za-z0-9_]+', '_', osp.basename(
                    osp.dirname(so)) + ' ' + pretty)[:120]
                with open(osp.join(args.dump, safe + '.sass'), 'w') as f:
                    f.write('\n'.join(i[3] for i in insns) + '\n')
    print(json.dumps(res))
    return 0


if __name__ == '__main__':
    sys.exit(main())
