"""The dropout dump kernel's integer floor, from its compiled SASS.

Usage (on a machine with the CUDA toolkit and a card):

    python turkish_asr_torch/scripts/dump_floor.py [B H T ...]

Builds ``libdropout_mask`` from ``turkish_asr_torch/csrc/dropout_mask.cu``
through ``ops/_build.py``, disassembles it with the toolkit's ``cuobjdump
-sass`` and prints, for each instance of the kernel, each outermost loop
(a backward branch and the instructions from its target up to it) and,
where the loop holds a 16-byte global store, the fewest instructions a
pass runs through that store: the pass that makes a 16-byte group in one
row. Beside them stand the instructions the integer ALU pipe runs
(``ALU_OPCODES``: integer and logic instructions but for the multiplies,
which the FMA pipe runs) and the opcodes by count.

Then, for each shape (default B=4, H=4, T=801, chip_smoke's), the floor:
the ALU instructions of that pass in the instance the shape takes, times
the (B*H*T*T) / 16 groups, over the ALU's 64 lanes a clock on each SM (the
CUDA programming guide's throughput table for compute capability 9.0) at
the card's SM count and its highest SM clock (nvidia-smi). It is a floor
that the bytes bound of ``chip_smoke.kernel_bounds`` does not see.

The last line is a JSON object of the counts and the floors.
"""

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

# Integer and logic opcodes, which the ALU pipe runs; IMAD and IMUL (also
# the moves and shifts written as IMAD.MOV, IMAD.SHL) run on the FMA pipe.
ALU_OPCODES = frozenset((
    "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "ICMP", "SEL", "PRMT", "LEA",
    "IABS", "IMNMX", "VIMNMX", "FLO", "POPC", "BREV", "BMSK", "SGXT", "PLOP3", "P2R", "R2P",
    "MOV",
))
ALU_LANES = 64  # ALU lanes a clock an SM, compute capability 9.0

_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*([0-9a-fA-F]+)\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_PREDICATE = re.compile(r"^@!?U?P[T0-9]+\s+")
_PREDICATE_OPERAND = re.compile(r"^\S+\s+!?U?P[T0-9]+\s*,")
_TARGET_LABEL = re.compile(r"`\((\.L_x_\d+)\)")
_TARGET_ADDRESS = re.compile(r"\b0x([0-9a-fA-F]+)\b")
_ENDS = ("BRA", "EXIT", "RET")  # no fall-through unless predicated

Instruction = collections.namedtuple("Instruction", "address opcode text target conditional")


def parse_sass(text):
    """{function name: [Instruction]} from ``cuobjdump -sass`` output. The
    opcode drops the predicate and the modifiers (``IMAD.MOV.U32`` is
    IMAD); a branch's target is the address it jumps to, by label or by
    number, else None; ``conditional`` is whether a predicate guards it
    (``@P0 BRA``, ``BRA P2, ...``)."""
    functions, name = {}, None
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1)
            functions[name] = ([], {}, [])  # instructions, labels, labels pending
            continue
        if name is None:
            continue
        instructions, labels, pending = functions[name]
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTRUCTION.match(line)
        if m:
            address, body = int(m.group(1), 16), _PREDICATE.sub("", m.group(2))
            conditional = body != m.group(2) or bool(_PREDICATE_OPERAND.match(body))
            labels.update((label, address) for label in pending)
            pending.clear()
            instructions.append((address, body.split()[0].split(".")[0], body, conditional))
    result = {}
    for fname, (instructions, labels, _) in functions.items():
        resolved = []
        for address, opcode, body, conditional in instructions:
            target = None
            if opcode == "BRA":
                m = _TARGET_LABEL.search(body)
                if m:
                    target = labels.get(m.group(1))
                else:
                    t = _TARGET_ADDRESS.search(body)
                    target = int(t.group(1), 16) if t else None
            resolved.append(Instruction(address, opcode, body, target, conditional))
        result[fname] = resolved
    return result


def _stores16(instruction):
    return instruction.opcode == "STG" and ".128" in instruction.text.split()[0]


def _group_path(body, start, end):
    """The fewest instructions from ``start`` to the backward branch at
    ``end`` through a 16-byte store, following the body's forward branches
    and fall-throughs (a nested loop's backward branch falls through):
    (instructions, ALU instructions, Counter of opcodes), or None. Every
    edge goes forward, so one pass in address order finds it."""
    index = {i.address: k for k, i in enumerate(body)}
    best = [[None, None] for _ in body]  # [k][stored]: (count, alu, opcodes)
    best[0][int(_stores16(body[0]))] = (1, int(body[0].opcode in ALU_OPCODES),
                                        collections.Counter([body[0].opcode]))
    for k, ins in enumerate(body):
        if ins.address == end:
            break
        nexts = []
        if ins.target is not None and ins.address < ins.target <= end and ins.target in index:
            nexts.append(index[ins.target])
        if (ins.opcode not in _ENDS or ins.conditional) and k + 1 < len(body):
            nexts.append(k + 1)
        for stored, here in enumerate(best[k]):
            if here is None:
                continue
            for n in nexts:
                state = stored or int(_stores16(body[n]))
                count, alu, opcodes = here
                if best[n][state] is None or count + 1 < best[n][state][0]:
                    best[n][state] = (count + 1, alu + int(body[n].opcode in ALU_OPCODES),
                                      opcodes + collections.Counter([body[n].opcode]))
    return best[index[end]][1]


def loops(instructions):
    """The outermost loops of one function, in address order: dicts of
    ``start`` and ``end`` (the backward branch's address), ``count`` (the
    instructions in [start, end]), ``nested`` (the loops inside it) and
    ``group``: the fewest instructions one pass runs from ``start`` to the
    backward branch through a 16-byte global store, as ``count``, ``alu``
    (of them, those in ALU_OPCODES) and ``opcodes``; None where the loop
    holds no such store. In the dropout dump that is the pass that makes
    a 16-byte group in one row."""
    spans = sorted({(i.target, i.address) for i in instructions
                    if i.target is not None and i.target <= i.address},
                   key=lambda s: (s[0], -s[1]))
    outer = []
    for start, end in spans:
        if outer and outer[-1][0] <= start and end <= outer[-1][1]:
            outer[-1][2] += 1
        else:
            outer.append([start, end, 0])
    result = []
    for start, end, nested in outer:
        body = [i for i in instructions if start <= i.address <= end]
        path = _group_path(body, start, end)
        result.append({"start": start, "end": end, "count": len(body), "nested": nested,
                       "group": None if path is None else
                       {"count": path[0], "alu": path[1], "opcodes": dict(path[2])}})
    return result


def dump_floor_ms(functions, B, H, T, sms, clock_hz):
    """(the integer ALU floor of the dump at (B, H, T) in ms, the loop it
    counts, the function): the instance the shape takes (32-bit indices
    while B*H*T*T + 15 < 2^32), its first loop that holds a 16-byte store."""
    n = B * H * T * T
    instance = "dump_keep_mask_kernelIjE" if n + 15 < 2 ** 32 else "dump_keep_mask_kernelImE"
    names = [name for name in functions if instance in name]
    if len(names) != 1:
        raise RuntimeError(f"expected one function named like {instance}, found {names}")
    loop = next((lp for lp in loops(functions[names[0]]) if lp["group"]), None)
    if loop is None:
        raise RuntimeError(f"{names[0]} has no loop with a 16-byte store")
    groups = -(-n // 16)
    return 1e3 * groups * loop["group"]["alu"] / (sms * ALU_LANES * clock_hz), loop, names[0]


def _max_sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout
    return 1e6 * float(out.splitlines()[0])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("shape", nargs="*", type=int, default=[4, 4, 801],
                        help="B H T of each dump whose floor is printed")
    args = parser.parse_args(argv)
    if not args.shape or len(args.shape) % 3:
        parser.error("give the shapes as triples B H T")
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    from turkish_asr_torch.ops._build import find_nvcc, library_path, load_library
    from turkish_asr_torch.ops.flash_attention import DUMP_SOURCES
    if not torch.cuda.is_available():
        raise RuntimeError("dump_floor reads the card's SM count and clock and needs a CUDA "
                           "card; torch.cuda.is_available() is False")
    load_library("dropout_mask", DUMP_SOURCES)
    cuobjdump = Path(find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(library_path("dropout_mask",
                                                                     DUMP_SOURCES))],
                          capture_output=True, text=True, check=True).stdout
    functions = parse_sass(text)
    print(f"{torch.cuda.get_device_name(0)}; dropout_mask: {len(functions)} functions",
          flush=True)
    result = {"functions": {}, "floors": []}
    for name, instructions in functions.items():
        found = loops(instructions)
        print(f"{name}: {len(instructions)} instructions, {len(found)} outermost loops")
        for lp in found:
            line = (f"  loop {lp['start']:#06x}-{lp['end']:#06x}: {lp['count']} instructions, "
                    f"{lp['nested']} loops nested")
            if lp["group"]:
                g = lp["group"]
                top = ", ".join(f"{op} {n}" for op, n in sorted(g["opcodes"].items(),
                                                                 key=lambda kv: -kv[1]))
                line += (f"; a pass through its 16-byte store {g['count']} instructions, "
                         f"{g['alu']} on the ALU ({top})")
            print(line)
        result["functions"][name] = {"instructions": len(instructions), "loops": found}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = _max_sm_clock_hz()
    for B, H, T in zip(*[iter(args.shape)] * 3):
        floor, loop, name = dump_floor_ms(functions, B, H, T, sms, clock)
        group = loop["group"]
        print(f"dump integer floor at B={B} H={H} T'={T}: {floor:.6f} ms ({group['alu']} ALU "
              f"of {group['count']} instructions a 16-byte group, {name} loop "
              f"{loop['start']:#06x}; {sms} SMs x {ALU_LANES} lanes at {clock / 1e6:.0f} MHz)")
        result["floors"].append({"B": B, "H": H, "T": T, "ms": floor, "function": name,
                                 "alu_per_group": group["alu"],
                                 "instructions_per_group": group["count"], "sms": sms,
                                 "clock_hz": clock})
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
