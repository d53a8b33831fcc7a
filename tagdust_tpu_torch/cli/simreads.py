"""simreads — read simulator with ground-truth-encoded names.

Re-implements the reference simulator (``simulate_reads.c:19-560``):
loads an EDITTAG barcode file (``Tag<i>:SEQ`` lines, :74-107), emits
``sim_numseq`` reads of the form

    mutated(5'linker) + mutated(barcode) + random read(+/- lenmod) +
    mutated(3'linker)

with truth encoded in the FASTQ name
(``@READ<i>;SEQ:<truth>;RBC:<bc>;BARNUM:<k>`` / ``@RAND...;BARNUM:0``,
:233-247, :305-317), plus a ``sim_random_frac`` share of fully random reads,
and co-generates the matching tagdust arch file, btrim pattern file and fastx
barcode file (:326-462).

Determinism: the RTEST LCG (`tagdust_tpu_torch.rng.CRand`) reproduces the exact
rand() stream of the ``simreads_rtest`` build, making outputs byte-identical
for a given seed.  The point/indel mutator mirrors ``mutate`` (:480-560).
"""

from __future__ import annotations

import sys
import time

from ..config import Params, parse_args
from ..rng import CRand


def _pick_nuc(r) -> str:
    if r < 0.25:
        return "A"
    if r < 0.5:
        return "C"
    if r < 0.75:
        return "G"
    return "T"


def mutate(rng: CRand, seq: str, error_rate: float, indel_frac: float) -> str:
    """Point/indel mutator, draw-for-draw identical to simulate_reads.c:480-560."""
    out = []
    n = len(seq)
    for j in range(n):
        r = rng.randf()
        if r <= error_rate:
            r = rng.randf()
            if r <= indel_frac:
                r = rng.randf()
                cutoff = 0.0 if j == n - 1 else 0.5
                if r <= cutoff:
                    # insertion: keep original base then a random one
                    r = rng.randf()
                    out.append(seq[j])
                    out.append(_pick_nuc(r))
                # else: deletion (emit nothing)
            else:
                # mismatch: redraw until different
                c = seq[j]
                while c == seq[j]:
                    r = rng.randf()
                    c = _pick_nuc(r)
                out.append(c)
        else:
            out.append(seq[j])
    return "".join(out)


def load_edittag_barcodes(path: str) -> list[str]:
    """Parse Tag<i>:SEQ lines (simulate_reads.c:74-107).

    A line contributes a barcode if it contains ':'; bases are read after the
    first ':' until a non-ACGT character.
    """
    barcodes = []
    with open(path) as fh:
        for line in fh:
            c = line.find(":")
            if c < 0:
                continue
            seq = []
            for ch in line[c + 1:]:
                if ch in "ACGTacgt":
                    seq.append(ch)
                else:
                    break
            barcodes.append("".join(seq))
    return barcodes


def run(param: Params) -> None:
    rng = CRand()
    seed = param.seed if param.seed else int(time.time() * 42) & 0xFFFFFFFF
    rng.srand(seed)

    if param.infiles == 0:
        raise SystemExit(1)
    barcodes = load_edittag_barcodes(param.infile[0])
    if len(barcodes) < param.sim_barnum:
        raise SystemExit("File contains too few barcodes.")

    out = open(param.outfile, "w") if param.outfile else sys.stdout

    num_with_read = int(float(param.sim_numseq) * (1.0 - param.sim_random_frac))
    barcode_used = 0
    for i in range(num_with_read):
        parts = []
        tmp = param.sim_5seq or ""
        if param.sim_barnum:
            barcode_used = rng.rand() % param.sim_barnum
            tmp += barcodes[barcode_used]
        parts.append(mutate(rng, tmp, param.sim_error_rate, param.sim_InDel_frac))

        if param.sim_readlen_mod:
            c = param.sim_readlen - param.sim_readlen_mod + (
                rng.rand() % (param.sim_readlen_mod * 2)
            )
        else:
            c = param.sim_readlen
        read = "".join(_pick_nuc(rng.randf()) for _ in range(c))
        parts.append(read)

        if param.sim_3seq:
            parts.append(
                mutate(rng, param.sim_3seq, param.sim_error_rate, param.sim_InDel_frac)
            )
        seq = "".join(parts)

        if param.sim_end_loss:
            start = rng.rand() % (param.sim_end_loss * 2)
            seq = seq[start:]
            start = rng.rand() % (param.sim_end_loss * 2)
            seq = seq[: len(seq) - start] if start else seq

        if param.sim_barnum:
            name = f"@READ{i};SEQ:{read};RBC:{barcodes[barcode_used]};BARNUM:{barcode_used + 1}"
        else:
            name = f"@READ{i};SEQ:{read};BARNUM:1"
        out.write(f"{name}\n{seq}\n+\n{'I' * len(seq)}\n")

    # fully random reads (simulate_reads.c:249-320)
    c = 0
    if param.sim_5seq:
        c += len(param.sim_5seq)
    if param.sim_3seq:
        c += len(param.sim_3seq)
    c += param.sim_barlen
    c += param.sim_readlen
    for i in range(num_with_read, param.sim_numseq):
        seq = "".join(_pick_nuc(rng.randf()) for _ in range(c))
        # (the reference's end-loss branch here operates on a stale buffer and
        #  does not alter `sequenced_read`; with sim_end_loss it still draws)
        if param.sim_end_loss:
            rng.rand()
            rng.rand()
        if param.sim_barnum:
            name = f"@RAND{i};SEQ:NONE;RBC:NONE;BARNUM:0"
        else:
            name = f"@RAND{i};SEQ:NONE;BARNUM:0"
        out.write(f"{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    if param.outfile:
        out.close()

    # companion files (simulate_reads.c:326-462)
    _write_companions(param, barcodes)


def _write_companions(param: Params, barcodes: list[str]) -> None:
    arch_path = f"{param.outfile}_tagdust_arch.txt"
    with open(arch_path, "w") as f:
        c = 1
        f.write("tagdust ")
        if param.sim_5seq:
            f.write(f"-{c} ")
            c += 1
            f.write(f"P:{param.sim_5seq} ")
        if param.sim_barnum:
            f.write(f"-{c} ")
            c += 1
            f.write("B:")
            f.write(",".join(barcodes[: param.sim_barnum - 1]))
            if param.sim_barnum > 1:
                f.write(",")
            f.write(f"{barcodes[param.sim_barnum - 1]} ")
        f.write(f"-{c} ")
        c += 1
        f.write("R:N ")
        if param.sim_3seq:
            f.write(f"-{c} ")
            c += 1
            f.write(f"P:{param.sim_3seq} ")
        f.write("in.fq ")
        f.write("-o out.fq")
        f.write("\n")

    btrim = (
        open(f"{param.outfile}_btrim_pattern.txt", "w")
        if param.outfile
        else sys.stdout
    )
    if param.sim_barnum:
        for i in range(param.sim_barnum):
            if param.sim_5seq:
                if param.sim_3seq:
                    btrim.write(f"{param.sim_5seq}{barcodes[i]} {param.sim_3seq}\n")
                else:
                    btrim.write(f"{param.sim_5seq}{barcodes[i]}\n")
            else:
                if param.sim_3seq:
                    btrim.write(f"{barcodes[i]} {param.sim_3seq}\n")
                else:
                    btrim.write(f"{barcodes[i]}\n")
    else:
        if param.sim_5seq:
            if param.sim_3seq:
                btrim.write(f"{param.sim_5seq} {param.sim_3seq}\n")
            else:
                btrim.write(f"{param.sim_5seq}\n")
        else:
            if param.sim_3seq:
                btrim.write(f"{param.sim_3seq}\n")
            else:
                btrim.write("\n")
    if param.outfile:
        btrim.close()

    if param.sim_barnum:
        fastx = (
            open(f"{param.outfile}_fastxbarcodefile.txt", "w")
            if param.outfile
            else sys.stdout
        )
        for i in range(param.sim_barnum):
            fastx.write(f"BC{i} {barcodes[i]}\n")
        if param.outfile:
            fastx.close()


def main(argv=None) -> None:
    param = parse_args(sys.argv[1:] if argv is None else argv)
    run(param)


if __name__ == "__main__":
    main()
