#!/usr/bin/env python3
"""B1's routes on one card, before and after a change to which line
lengths take which route, for the tree whose root is given.

    python3 scripts/route_times.py times ROOT TAG OUT.json
    python3 scripts/route_times.py timescheck ROOT TAG OUT.json
    python3 scripts/route_times.py sweep ROOT OUT.json
    python3 scripts/route_times.py generic ROOT OUT.json
    python3 scripts/route_times.py check ROOT OUT.json
    python3 scripts/route_times.py fit RUN.json [RUN.json ...] OUT.json
    python3 scripts/route_times.py sass OLD.so NEW.so OUT.json
    python3 scripts/route_times.py split ROOT TAG OUT.json
    python3 scripts/route_times.py splitcheck ROOT TAG OUT.json
    python3 scripts/route_times.py splitgen ROOT TAG OUT.json
    python3 scripts/route_times.py splitgencheck ROOT TAG OUT.json
    python3 scripts/route_times.py chirpm ROOT TAG OUT.json
    python3 scripts/route_times.py chirpmcheck ROOT TAG OUT.json
    python3 scripts/route_times.py nested ROOT TAG OUT.json
    python3 scripts/route_times.py nestedcheck ROOT TAG OUT.json
    python3 scripts/route_times.py wide ROOT TAG OUT.json
    python3 scripts/route_times.py wideall ROOT TAG OUT.json
    python3 scripts/route_times.py widesplits ROOT TAG OUT.json
    python3 scripts/route_times.py widepicks ROOT TAG OUT.json
    python3 scripts/route_times.py widecheck ROOT TAG OUT.json
    python3 scripts/route_times.py splitpasses ROOT TAG OUT.json
    python3 scripts/route_times.py splitfold ROOT TAG OUT.json
    python3 scripts/route_times.py generalrules ROOT TAG OUT.json

``times`` runs the port of the tree at ROOT (its ``src`` first on the
path; the kernel is built there at first use): ``fft_fourstep`` on
contiguous lines at :data:`SHAPES`, each on the route that tree's
``radix.kernel_path`` names, beside ``torch.fft.fft`` and the bound, and
a C2C ``plan_fft`` of :data:`GRID` on the kernel backend (launches per
route and layout, line copies) beside ``fftn`` and a ``cufft`` plan.
Compare two trees within one call: parent, change, change, parent.
``timescheck`` does the same, without the plan, at :data:`CHECK_SHAPES`:
the lengths of ``check``, each on its tree's own route, and c64 30976.

``sweep`` times every radix-route length of the tree at ROOT whose odd
part is 65 or more, both dtypes, at 64 MB of lines: the radix kernel,
the dense kernel of the same library on the same lines (the route
forced: ``radix.kernel_path`` answers "dense" for the timing), and
``torch.fft.fft``.

``generic`` times the dense route against the chirp route on the same
lines, both in the library of the tree at ROOT, at :data:`GENERIC_LENGTHS`
(lengths with a prime factor past 13) at 256 MB of lines, each route
forced for N alone (``radix.kernel_path`` answers it, ``dense.takes``
admits N), and ``torch.fft.fft``; ``check`` does the same at
:data:`GENERIC_CHECK`, lengths the fit did not see.  ``fit`` (no card
needed) fits both routes' times over one or more ``generic`` and
``chirpm`` runs: the constants of ``dense.takes``' rule and of the
chirp's M (:func:`fit`), the lengths that this checkout routes to the
slower of the two, and how far its M picks are from the fastest forced.
``dense.MOVE_MARGIN`` keeps a length on the dense route unless the fit
puts the chirp that much faster.

``split`` times the lengths of :data:`SPLIT_SWEEP` (the split route's
rule: 13-smooth lines past one block and 23*2^k, which the chirp held or
which raised) at 256 MB of lines in the tree at ROOT: each on the route
that tree's ``radix.kernel_path`` names ("raises" where it raises), then,
where the tree has ``split.rule_factors``, every (P, Q) its build
instantiates for N (P of ``split.COLUMN_SIZES``, Q a pass-B row of
``split.ROW_SIZES`` or a long-line row that pass C takes), each plan
forced, beside ``torch.fft.fft`` and the bound.  ``splitcheck`` does the
same at :data:`SPLIT_CHECK`, lengths the sweep did not see.  Run them
parent, change, change, parent.

``splitgen`` times the lengths of :data:`SPLIT_GENERAL_SWEEP` (the
split route's general plans, ``split.general_factors``: 13-smooth lines
past one block that no other plan holds, which the chirp held or which
raised) at 256 MB of lines in the tree at ROOT: each on the route that
tree's ``radix.kernel_path`` names ("raises" where it raises), then, where
the tree has ``split.general_candidates``, its candidate plans (every
radix pass A and up to 14 dense ones spread over P), each forced, beside
``torch.fft.fft`` and the bound.  ``splitgencheck`` does the same at
:data:`SPLIT_GENERAL_CHECK`, lengths the sweep did not see.  Run them
parent, change, change, parent.

``chirpm`` times the chirp route at :data:`CHIRP_SWEEP` (256 MB of
lines) with its M forced to several 13-smooth candidates from 2N - 1 to
twice that (the least odd, even, multiple of 4, 16 and 64, the power of
two, the tree's own; ``chirp.chirp_plan`` answers each for N alone),
beside ``torch.fft.fft`` and the bound; ``fit`` reads it for
``dense.GENERIC_COST``'s chirp costs.  ``chirpmcheck`` does the same at
:data:`CHIRP_CHECK`, lengths the fit did not see.  ``nested`` times the
nested plans (``split.nested_factors``, past the split route's old
limit) at :data:`NESTED_SWEEP`, 512 MB of lines, the tree's plan and its
candidates forced (``split.any_candidates``: every radix pass A, up to 10
dense ones); ``nestedcheck`` at :data:`NESTED_CHECK`.

``wide`` forces, on the same lines at 512 MB, ``radix_kernel`` and the
wide kernel's plans (``fft_wide.cuh``; the rule's pick of
``longline.wide_candidates`` and up to four others: another split, one
line a tile, the most lines) at :data:`WIDE_SWEEP`, from a probe library
it builds itself under ROOT's ``build/wide_probe/`` (those
instantiations alone, :data:`PROBE_PARTS` units at once; ptxas's
registers and spills per plan), each plan also held against
``longline.emulate`` on a ragged batch with the epilogues; ``wideall``
does the same at every wide line of ROOT's ``longline.WIDE`` and
``widesplits`` at :data:`WIDE_SPLITS` and every complex128 wide line,
with every split in both orders (:func:`_split_plans`), and
``widepicks`` at every wide line with the rule's pick alone; each reads
``radix_kernel`` and the plans again in the reverse order (``ms_again``,
``radix_ms_again``).  ``widecheck``
runs ``times`` at :data:`WIDE_CHECK` (held out) and :data:`WIDE_KEPT`
(routes that stay), then the strided entry and the 384^3 and 600^3
plans; run it parent, change, change, parent.

``splitpasses`` times the split route's passes apart at
:data:`SPLIT_PASSES` (the general, nested and long-row plans, 256 or 512
MB of lines), each on the route and plan of the tree at ROOT: the whole
call with CUDA events beside ``torch.fft.fft`` and the bound, then 10
calls under ``torch.profiler``, each kernel's device time a call summed by
pass: pass A (the radix kernel's ``kRadixSplitA``, ``dense_column_kernel``),
the row pass (the dense, long-line or radix rows, or the folded
``split_fold_*`` kernels), pass C (``split_transpose_*``), with the
launches of one call.  Run it parent, change, change, parent.

``splitfold`` forces the folded pass B's layout (``split.FoldLayout``:
the cluster's blocks C; on dense rows where C = 1 the ring's depth) at
:data:`SPLIT_PASSES`' lengths whose rows take it, each split call against
``torch.fft``, beside the tree's own layout; the sweep that fixed
``split.FOLD_RUN_BYTES`` and ``FOLD_DEPTH``.

``generalrules`` times, at 256 MB of lines, the general plans of
:data:`SPLIT_GENERAL_SWEEP` and :data:`SPLIT_GENERAL_CHECK` each on the
route and plan of the tree at ROOT, then :data:`RULES_SHAPES` (512 MB:
routes whose code a change to the split route's rows may move: the wide
lines whose kernels share ``mixed_tiles``, a nested plan and chirps over
split plans of M) likewise; where the tree folds pass C into dense rows
(``split.fold_layout``), also the general rule's pick under each
(``GENERAL_P``, ``GENERAL_Q_MAX``) of :data:`GENERAL_RULES`, each distinct
plan forced, beside ``torch.fft.fft`` and the bound.  Run it parent,
change, change, parent; pick the constants on the sweep's lengths and
read them on the check's.

``sass`` compares ``cuobjdump -sass`` of two builds function by
function: only instruction and encoding lines (a module's header would
otherwise count as its last function's), each line's address comment
dropped and its whitespace collapsed (cuobjdump pads its columns to each
module's widest line).

CUDA events, 10 calls after 2 of warm-up; every result goes to OUT.json
and a line per measurement to the standard output.  Needs a CUDA card
(``times``, ``sweep``, ``generic``, ``check``) or ``cuobjdump``
(``sass``); ``fit`` reads OUT.json files of ``generic`` or ``check``.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

#: (dtype name, lines, N): lengths that the split route's general plans
#: (``split.general_factors``) move, at 256 MB of lines: off the chirp
#: complex64 29106 = 2*3^3*7^2*11, 30976 = 256 x 121, the odd 33075,
#: 44100, 96000 = 256 x 375, 10^6 and 13^6 = 4826809, complex128 14406 =
#: 2*3*7^4; at 512 MB lengths that raised past the chirp's limit
#: (complex64 10^7 and 3^15, complex128 2278125 = 3^6*5^5 and 4084223 =
#: 11*13^5); and lengths whose route stays (complex64 4864 long, 4725
#: dense, 33792 split by the rule, 2^24 split), with the rest of
#: ``chip_smoke.py``'s ``[gaps]`` lengths on the dense route (complex64
#: 2730, 3430, 4050, 16896, 23040, 3264 and 1616, complex128 990, 8448
#: and 1824), whose kernel shares its stage code with the general plans'
#: pass A; then the chirp's lengths (``chip_smoke.py``'s ``[chirp]``,
#: whose M the M rule moved, and c64 816, a generic stage that
#: ``dense.takes`` weighs against the chirp; c64 2279 = 43*53, complex128
#: 1616 and 808, which the refit moved from the dense route to the chirp,
#: and c64 244 = 4*61, from the chirp to the dense route) and, at 512 MB,
#: the lengths
#: that raised past the old limits (the chirp's c64 8388617, 2^24 + 1,
#: c128 2^21 + 1; the nested plans' c64 3^16, 2^25, c128 2^23).
SHAPES = tuple(
    (dt, (256 << 20) // (n * (8 if dt == "complex64" else 16)), n)
    for dt, n in (("complex64", 29106), ("complex64", 30976),
                  ("complex64", 33075), ("complex64", 44100),
                  ("complex64", 96000), ("complex64", 10 ** 6),
                  ("complex64", 13 ** 6), ("complex128", 14406),
                  ("complex64", 4864), ("complex64", 4725),
                  ("complex64", 33792), ("complex64", 2730),
                  ("complex64", 3430), ("complex64", 4050),
                  ("complex64", 16896), ("complex64", 23040),
                  ("complex64", 3264), ("complex64", 1616),
                  ("complex128", 990), ("complex128", 8448),
                  ("complex128", 1824), ("complex64", 816),
                  ("complex64", 7424), ("complex64", 10007),
                  ("complex64", 20011), ("complex64", 4831),
                  ("complex128", 3001), ("complex128", 3712),
                  ("complex64", 2279), ("complex64", 244),
                  ("complex128", 1616), ("complex128", 808))) + tuple(
    (dt, (512 << 20) // (n * (8 if dt == "complex64" else 16)), n)
    for dt, n in (("complex64", 10 ** 7), ("complex64", 3 ** 15),
                  ("complex128", 2278125), ("complex128", 4084223),
                  ("complex64", 1 << 24), ("complex64", 8388617),
                  ("complex64", (1 << 24) + 1), ("complex128", (1 << 21) + 1),
                  ("complex64", 3 ** 16), ("complex64", 1 << 25),
                  ("complex128", 1 << 23)))
#: (dtype name, N) of ``generic``: lengths with a prime factor past 13,
#: by the route the chirp's M takes (complex64: M up to 4096 on the radix
#: route, 8192 and 16384 on the long-line route; complex128: up to 1024
#: radix, 2048 to 8192 long-line), each band at M/N near 2 (the chirp's
#: least padding) and near 4, the sum of the generic primes from 17 to
#: 4831, and two primes (2279 = 43*53, 1591 = 37*43, 323 = 17*19,
#: complex128 1961 = 37*53); then (from 53 on) lengths where a first fit
#: to the others put the two routes within 12% of each other, M from 128
#: to 16384.
GENERIC_LENGTHS = tuple(("complex64", n) for n in (
    3264, 3648, 2944, 3712, 3968, 4736, 3392, 3232, 4112, 4084, 4831,
    3776, 4288, 2144, 2528, 4081, 2279, 4558, 2121, 3948,
    1632, 1824, 1472, 1856, 1984, 1184, 1696, 1616, 1028, 2042,
    2032, 1812, 1991, 1899, 2043, 1111, 1143, 1057, 1086, 1591,
    848, 808, 1016, 771, 424, 508, 244, 536, 296, 257, 499, 323,
    53, 71, 106, 73, 177, 235, 183, 430, 267, 410, 854, 946, 731, 1957,
    1703, 1695, 2485, 2212, 2222, 4715, 4686, 4672, 101, 123, 246)) + tuple(
    ("complex128", n) for n in (
        1632, 1824, 1472, 1856, 1984, 1184, 1696, 1616, 1028, 2042, 2417,
        1888, 1072, 1264, 1111, 1961, 2032, 2124, 848, 808, 536, 1016,
        424, 404, 508, 257, 268, 296, 499, 244, 323,
        53, 73, 122, 79, 183, 236, 235, 291, 436, 474, 654, 830, 606, 1587,
        1505, 1130, 2260, 2133, 2225, 101, 123, 194))
#: (dtype name, N) of ``check``: lengths that ``GENERIC_LENGTHS`` leaves
#: out, drawn at random (seeded), 12 per dtype where
#: ``dense.GENERIC_COST`` (fit to ``GENERIC_LENGTHS``) puts the two
#: routes within 10% of each other and 4 where it puts them 10-50% apart.
GENERIC_CHECK = tuple(("complex64", n) for n in (
    335, 423, 639, 1038, 1145, 1467, 1651, 2158, 2829, 3180, 3237, 3245,
    3384, 4240, 4272, 4371)) + tuple(("complex128", n) for n in (
        59, 178, 314, 356, 581, 793, 1363, 1369, 1504, 1580, 1740, 2086,
        2117, 2241, 2286, 2379))
#: (dtype name, lines, N) of ``timescheck``: c64 30976 = 256 x 121 (a
#: general split plan, which kept its route; one change run read it 51%
#: slower than the others), then the lengths of ``check``, at 256 MB of
#: lines, most of which ``dense.MOVE_MARGIN`` moves from the dense route
#: to the chirp.
CHECK_SHAPES = tuple(
    (dt, (256 << 20) // (n * (8 if dt == "complex64" else 16)), n)
    for dt, n in (("complex64", 30976),) + GENERIC_CHECK)
#: (dtype name, N) of ``split``: the split route's rule lengths, from
#: the families it takes: 23*2^k from the shortest to the longest
#: (complex64 23*2^10 = 256 x 92 to 23*2^19 = 1024 x 11776, complex128
#: 23*2^9 to 23*2^17), odd parts 33 to 231 with one (P, Q) or several,
#: radix rows and long-line rows, Q with one factor of 2 (complex64
#: 945*2^11 = 1024 x 1890, complex128 405*2^10 = 512 x 810: the largest
#: inter-step twiddle tables, P*(2 + Q/2) entries), and past the chirp's
#: limit (complex64 33*2^18 = 8650752); then 8 per dtype drawn at random
#: (seeded) among the rule's lengths with two or more instantiated (P,
#: Q), first run as a held-out check of the first rule (the least P on a
#: radix row) and, with the lengths above, the readings that fixed
#: ``split.ROW_SHORT``.
SPLIT_SWEEP = tuple(("complex64", n) for n in (
    23 << 10, 23 << 14, 23 << 17, 23 << 19, 33 << 10, 45 << 11, 75 << 12,
    99 << 13, 105 << 14, 33 << 18, 35 << 12, 49 << 13, 117 << 12,
    121 << 13, 945 << 11)) + tuple(("complex128", n) for n in (
        23 << 9, 23 << 13, 23 << 17, 33 << 9, 45 << 12, 99 << 14, 35 << 11,
        49 << 12, 121 << 11, 405 << 10)) + tuple(
    ("complex64", n) for n in (
        67584, 100352, 168960, 200704, 663552, 903168, 3833856,
        6029312)) + tuple(("complex128", n) for n in (
            35840, 42240, 64000, 75264, 76800, 79872, 146432, 1982464))
#: (dtype name, N) of ``splitcheck``: rule lengths that ``SPLIT_SWEEP``
#: leaves out, drawn at random (seeded) among those with two or more
#: instantiated (P, Q): 12 complex64 ones where ``split.ROW_SHORT``
#: decides (a radix candidate with Q past 1024 or P = 1024), 4
#: complex128 ones.
SPLIT_CHECK = tuple(("complex64", n) for n in (
    153600, 270336, 315392, 351232, 430080, 495616, 602112, 718848,
    1146880, 1228800, 1327104, 1605632)) + tuple(
    ("complex128", n) for n in (37632, 138240, 286720, 450560))
#: (dtype name, N) of ``splitgen``: lengths of the split route's general
#: plans (13-smooth lines past one block that no other plan holds), the
#: ones ``SHAPES`` times, then two per band of log N drawn at random
#: (seeded) among the general lengths, 8 bands complex64 and 6
#: complex128.
SPLIT_GENERAL_SWEEP = tuple(("complex64", n) for n in (
    29106, 30976, 33075, 44100, 96000, 10 ** 6, 13 ** 6, 10 ** 7, 3 ** 15,
    31185, 36288, 72171, 83200, 196830, 274560, 320166, 665500, 715000,
    758912, 2395008, 3009825, 3638250, 4915625, 12057136,
    13856832)) + tuple(("complex128", n) for n in (
        14406, 2278125, 4084223, 24500, 28028, 36855, 68992, 117000,
        211200, 246402, 440440, 898128, 1397760, 2141568, 2388204))
#: (dtype name, N) of ``splitgencheck``: general lengths that
#: ``SPLIT_GENERAL_SWEEP`` leaves out, drawn at random (seeded) once the
#: sweep had fixed the rule (``split.GENERAL_P``, ``GENERAL_Q_MAX``): one
#: per band of log N, 10 bands complex64 and 6 complex128, and one per
#: dtype among the lengths with two radix pass A candidates.
SPLIT_GENERAL_CHECK = tuple(("complex64", n) for n in (
    31590, 56000, 109350, 331695, 449064, 819819, 1597200, 3071250,
    4920750, 15360000, 681472)) + tuple(("complex128", n) for n in (
        21125, 41184, 136125, 431244, 650650, 2283008, 194688))
#: (dtype name, N, MB of lines) of ``splitpasses``: the split route's
#: plans that ran three HBM passes before their pass C was folded into
#: pass B, at ``[split_general]``'s and ``[split]``'s sizes: the general
#: plans (complex64 10^7 = 1600 x 6250, 3^15 = 2187 x 6561, 10^6, 30976 =
#: 256 x 121, 13^6; complex128 2278125 = 625 x 3645), the long-line rows
#: (complex128 2^22 = 512 x 8192, complex64 2^24 = 1024 x 16384, the mixed
#: complex128 25*2^17 = 512 x 6400, 27*2^17, 23*2^17; complex64 21*2^19 =
#: 1024 x 10752, and at 256 MB the rule's 3833856 = 512 x 7488 and 6029312
#: = 512 x 11776, the mixed rows of R3 = 16 and 32), the nested plans
#: (complex64 3^16 = 2187 x 19683 on dense rows, complex128 2^23 on rows
#: of the split route).
SPLIT_PASSES = (("complex64", 10 ** 7, 512), ("complex64", 3 ** 15, 512),
                ("complex64", 10 ** 6, 256), ("complex64", 30976, 256),
                ("complex64", 13 ** 6, 256), ("complex128", 2278125, 512),
                ("complex128", 1 << 22, 512), ("complex64", 1 << 24, 512),
                ("complex128", 25 << 17, 512), ("complex128", 27 << 17, 512),
                ("complex128", 23 << 17, 512), ("complex64", 21 << 19, 512),
                ("complex64", 3833856, 256), ("complex64", 6029312, 256),
                ("complex64", 3 ** 16, 512), ("complex128", 1 << 23, 512))
#: (dtype name, N) of ``chirpm``: chirp lengths whose M takes the dense
#: route's kernel (complex64 to 14215, complex128 to 7098) and a split
#: plan past it, both dtypes, from short lines to the old limit: primes
#: and 29*2^k, 101*2^k.
CHIRP_SWEEP = tuple(("complex64", n) for n in (
    101, 257, 521, 1009, 2039, 3232, 4831, 7424, 10007, 14009, 14503,
    20011, 40009, 100003, 1000003)) + tuple(("complex128", n) for n in (
        101, 521, 1201, 3001, 3712, 5003, 7001, 8009, 20011, 100003))
#: (dtype name, N) of ``chirpmcheck``: chirp lengths ``CHIRP_SWEEP``
#: leaves out, drawn at random (seeded) once the fit had fixed the costs.
CHIRP_CHECK = tuple(("complex64", n) for n in (
    613, 2903, 6553, 12011, 17393, 65537)) + tuple(
        ("complex128", n) for n in (409, 2417, 4099, 9973))
#: (dtype name, N) of ``nested``: lengths past the split route's old limit
#: (2^24 complex64, 2^22 complex128), 13-smooth and with a prime factor
#: past 13, whose rows fit one block or run on the split route one level
#: down; at 512 MB of lines (one line where a line is longer).
NESTED_SWEEP = tuple(("complex64", n) for n in (
    1 << 25, 3 ** 16, 5 ** 11, 10 ** 8, 17 << 21, 1 << 28)) + tuple(
        ("complex128", n) for n in (1 << 23, 3 ** 15, 5 ** 10, 1 << 25))
#: (dtype name, N) of ``nestedcheck``: lengths ``NESTED_SWEEP`` leaves out;
#: the first eight's readings also fixed ``split.NESTED_ONE_P``, the last
#: three are held out from it.
NESTED_CHECK = tuple(("complex64", n) for n in (
    6 ** 10, 7 ** 9, 19 << 22)) + tuple(
        ("complex128", n) for n in (3 ** 14 * 2, 13 ** 6 * 2)) + tuple(
    ("complex64", n) for n in (2 ** 5 * 3 ** 12, 5 ** 6 * 7 ** 4)) + (
        ("complex128", 2 ** 5 * 3 ** 11), ("complex64", 4 * 3 ** 14),
        ("complex64", 2 * 3 ** 9 * 5 ** 4), ("complex128", 11 * 3 ** 12))
#: (dtype name, N) of ``wide``: the radix route's wide lines
#: (``longline.WIDE``: a factor past 32 values, complex64, or 16,
#: complex128), at 512 MB of lines: the gaps to ``torch.fft`` that
#: ``radix_kernel`` left widest (complex64 2944, 3200, 3600, 3840, 4032,
#: 1800, 2400; complex128 864, 900, 736), the powers of two (complex64
#: 2048, 4096, complex128 512, 1024), complex64 1000, and lengths spread
#: from the low end of the candidates (complex64 792, complex128 68) up.
WIDE_SWEEP = tuple(("complex64", n) for n in (
    2944, 3200, 3600, 3840, 4032, 1800, 2400, 2048, 4096, 1000, 792, 880,
    882, 936, 1088, 1200, 1350, 1458, 1536, 2000, 2176, 2500, 2700, 3000,
    3456, 3528)) + tuple(("complex128", n) for n in (
        864, 900, 736, 512, 1024, 68, 92, 162, 200, 250, 320, 400, 600,
        768))
#: (dtype name, N) of ``widecheck``: wide lines ``WIDE_SWEEP`` leaves out,
#: spread over the moved range (11 complex64, 5 complex128), then lengths
#: whose route stays: the radix route's c64 960 and 1024 and c128 200 and
#: 320 (short of ``longline.WIDE_LINE_MIN_BYTES``), the long route's c64
#: 4800, the dense route's c64 2730, split plans whose rows are wide lines
#: (c64 225792 = 256 x 882, 552960 = 512 x 1080, c128 67584 = 128 x 528).
WIDE_CHECK = tuple(("complex64", n) for n in (
    968, 1152, 1296, 1600, 1920, 2304, 2592, 2880, 3072, 3240,
    3584)) + tuple(("complex128", n) for n in (448, 480, 640, 800, 960))
WIDE_KEPT = tuple(("complex64", n) for n in (
    960, 1024, 4800, 2730, 225792, 552960)) + tuple(
        ("complex128", n) for n in (200, 320, 67584))
#: (dtype name, shape, axis) of ``widecheck``'s strided entry: B4's
#: (512, 512, 512) along dim 1, and a wide line along a strided axis
#: (the radix kernel keeps it).
WIDE_STRIDED = (("complex64", (512, 512, 512), 1),
                ("complex64", (16, 1000, 4096), 1))
#: ``[mixed_plan]``'s C2C grids.
WIDE_GRIDS = ((384, 384, 384), (600, 600, 600))
#: One face of the LLC4320 ocean grid (MITgcm/ECCO), complex64.
GRID = (4320, 4320)
SWEEP_BYTES = 64 << 20
#: Published peaks of one H100 SXM (as ``chip_smoke.py``).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


# The helpers below repeat ``chip_smoke.py``'s: importing it would put
# this checkout's ``src`` first on the path, ahead of ROOT's.


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(b: int, n: int, itemsize: int) -> float:
    """Each line read and written once over HBM, or 5 N log2 N flops a
    line over the fp32 peak, whichever takes longer."""
    return max(2 * b * n * itemsize / PEAK_HBM_BYTES,
               b * n * 5 * math.log2(n) / PEAK_FP32_FLOPS) * 1e3


def scaled_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def _port(root: str):
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("route_times: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch


def _lines(torch, dtype, b: int, n: int):
    gen = torch.Generator(device="cuda").manual_seed(n)
    return torch.randn((b, n), dtype=dtype, device="cuda", generator=gen)


def times(root: str, tag: str, shapes=SHAPES, plan: bool = True) -> dict:
    torch = _port(root)
    from repro_torch import make_mesh, plan_fft
    from repro_torch.kernels import fft_matmul as tfm
    from repro_torch.kernels import ops, radix
    out = {"tag": tag, "root": os.path.abspath(root), "lines": []}
    for dt, b, n in shapes:
        dtype = getattr(torch, dt)
        x = _lines(torch, dtype, b, n)
        tfm.reset_launch_counts()
        rec = {"dtype": dt, "shape": [b, n],
               "path": radix.kernel_path(n, dtype),
               "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
               "bound_ms": bound_ms(b, n, x.element_size())}
        try:
            y = tfm.fft_fourstep(x)
        except (ValueError, RuntimeError) as e:
            # past a route's domain (the tree before the split rule)
            rec.update(path="raises", raised=str(e), ms=None)
            print(f"[{tag}] raises ({b}, {n}) {dt}: {e}", flush=True)
            out["lines"].append(rec)
            del x
            continue
        torch.cuda.synchronize()
        rec.update(launches=dict(tfm.fft_fourstep.path_launches),
                   err_vs_torch_fft=scaled_err(y, torch.fft.fft(x)),
                   ms=time_ms(lambda: tfm.fft_fourstep(x)))
        del x, y
        torch.cuda.empty_cache()
        print(f"[{tag}] {rec['path']} ({b}, {n}) {dt}: {rec['ms']:.4f} ms, "
              f"torch.fft {rec['torch_fft_ms']:.4f}, bound "
              f"{rec['bound_ms']:.4f}; vs torch.fft "
              f"{rec['err_vs_torch_fft']:.2e}; launches {rec['launches']}",
              flush=True)
        out["lines"].append(rec)
    if not plan:
        return out
    mesh = make_mesh((1, 1), ("data", "model"))
    plan = plan_fft(mesh, GRID, backend="kernel")
    cplan = plan_fft(mesh, GRID, backend="cufft")
    gen = torch.Generator(device="cuda").manual_seed(GRID[0])
    x = torch.randn(GRID, dtype=torch.complex64, device="cuda",
                    generator=gen)
    tfm.reset_launch_counts()
    ops.copies["lines"] = 0
    y = plan.forward(x)
    torch.cuda.synchronize()
    rec = {"grid": list(GRID),
           "launches": dict(tfm.fft_fourstep.path_launches),
           "layouts": dict(tfm.fft_fourstep.layout_launches),
           "copies": ops.copies["lines"],
           "err_vs_fftn": scaled_err(y, torch.fft.fftn(x)),
           "fwd_ms": time_ms(lambda: plan.forward(x), 5),
           "inv_ms": time_ms(lambda: plan.inverse(y, sharded_in=True), 5),
           "cufft_ms": time_ms(lambda: cplan.forward(x), 5),
           "fftn_ms": time_ms(lambda: torch.fft.fftn(x), 5),
           "bound_ms": len(GRID) * bound_ms(x.numel() // GRID[-1],
                                            GRID[-1], 8)}
    print(f"[{tag}] plan {GRID}: forward {rec['fwd_ms']:.4f} ms, inverse "
          f"{rec['inv_ms']:.4f}, cufft plan {rec['cufft_ms']:.4f}, fftn "
          f"{rec['fftn_ms']:.4f}, bound {rec['bound_ms']:.4f}; vs fftn "
          f"{rec['err_vs_fftn']:.2e}; launches {rec['launches']} "
          f"{rec['layouts']}, line copies {rec['copies']}", flush=True)
    out["plan"] = rec
    return out


def sweep(root: str) -> dict:
    torch = _port(root)
    from repro_torch.core.transforms import factorize
    from repro_torch.kernels import fft_matmul as tfm
    from repro_torch.kernels import radix
    routed = radix.kernel_path
    out = {"root": os.path.abspath(root), "bytes": SWEEP_BYTES,
           "lengths": []}
    for dtype, sizes in radix.RADIX_SIZES.items():
        dt = str(dtype).removeprefix("torch.")
        for n in sizes:
            if radix.odd_part(n) < 65:
                continue
            b = SWEEP_BYTES // (n * dtype.itemsize)
            x = _lines(torch, dtype, b, n)
            lib = torch.fft.fft(x)
            radix_err = scaled_err(tfm.fft_fourstep(x), lib)
            radix_ms = time_ms(lambda: tfm.fft_fourstep(x))
            radix.kernel_path = lambda m, d: "dense"
            try:
                dense_err = scaled_err(tfm.fft_fourstep(x), lib)
                dense_ms = time_ms(lambda: tfm.fft_fourstep(x))
            finally:
                radix.kernel_path = routed
            rec = {"dtype": dt, "shape": [b, n],
                   "factors": list(factorize(n)),
                   "radix_ms": radix_ms, "dense_ms": dense_ms,
                   "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
                   "bound_ms": bound_ms(b, n, dtype.itemsize),
                   "radix_err": radix_err, "dense_err": dense_err}
            del x, lib
            print(f"[sweep] ({b}, {n}) {dt} {rec['factors']}: radix "
                  f"{radix_ms:.4f} ms, dense {dense_ms:.4f}, torch.fft "
                  f"{rec['torch_fft_ms']:.4f}, bound {rec['bound_ms']:.4f}"
                  f"; vs torch.fft {radix_err:.2e} / {dense_err:.2e}",
                  flush=True)
            out["lengths"].append(rec)
    recs = out["lengths"]
    slower = [r["shape"][1] for r in recs if r["radix_ms"] > r["dense_ms"]]
    ratio = [r["radix_ms"] / r["torch_fft_ms"] for r in recs]
    print(f"[sweep] {len(recs)} lengths; radix slower than dense at "
          f"{slower}; radix against torch.fft {min(ratio):.2f}x to "
          f"{max(ratio):.2f}x")
    return out


def generic(root: str, lengths=GENERIC_LENGTHS) -> dict:
    torch = _port(root)
    from repro_torch.kernels import chirp, dense, radix
    from repro_torch.kernels import fft_matmul as tfm
    routed, kept = radix.kernel_path, dense.takes
    out = {"root": os.path.abspath(root), "bytes": 256 << 20,
           "lengths": []}
    for dt, n in lengths:
        dtype = getattr(torch, dt)
        b = (256 << 20) // (n * dtype.itemsize)
        x = _lines(torch, dtype, b, n)
        lib = torch.fft.fft(x)
        cplan = chirp.chirp_plan(n, dtype)
        m = cplan.m
        chain = dense.chain(n)
        rec = {"dtype": dt, "shape": [b, n], "chain": list(chain),
               "s": sum(p for p in chain if p > 13), "m": m,
               "m_path": cplan.route, "path": routed(n, dtype)}
        try:
            for path in ("dense", "chirp"):
                # the route forced for N alone
                radix.kernel_path = (lambda k, d, path=path:
                                     path if k == n else routed(k, d))
                dense.takes = lambda k, d: k == n or kept(k, d)
                tfm.reset_launch_counts()
                rec[f"{path}_err"] = scaled_err(tfm.fft_fourstep(x), lib)
                rec[f"{path}_launches"] = \
                    tfm.fft_fourstep.path_launches[path]
                rec[f"{path}_ms"] = time_ms(lambda: tfm.fft_fourstep(x))
        finally:
            radix.kernel_path, dense.takes = routed, kept
        rec["torch_fft_ms"] = time_ms(lambda: torch.fft.fft(x))
        rec["bound_ms"] = bound_ms(b, n, dtype.itemsize)
        del x, lib
        torch.cuda.empty_cache()
        print(f"[generic] ({b}, {n}) {dt} {rec['chain']} s={rec['s']} "
              f"M={m} on {rec['m_path']} (routed {rec['path']}): dense "
              f"{rec['dense_ms']:.4f} ms, chirp {rec['chirp_ms']:.4f}, "
              f"torch.fft {rec['torch_fft_ms']:.4f}, bound "
              f"{rec['bound_ms']:.4f}; vs torch.fft {rec['dense_err']:.2e}"
              f" / {rec['chirp_err']:.2e}", flush=True)
        out["lengths"].append(rec)
    return out


def _split_candidates(split, n: int, dtype) -> list:
    """Every (P, Q, row route) the build instantiates for N: P of
    ``COLUMN_SIZES``, Q a radix row (``ROW_SIZES``) or a long-line row
    of a multiple of 32 (of ``split.FOLD_LONG_ROWS`` where the tree folds
    pass C into its long rows, which instantiates those alone)."""
    from repro_torch.kernels import longline
    out = []
    for p in split.COLUMN_SIZES[dtype]:
        q = n // p
        if n % p:
            continue
        if q in split.ROW_SIZES[dtype]:
            out.append((p, q, "radix"))
        elif q in getattr(split, "FOLD_LONG_ROWS", longline.FACTORS)[
                dtype] and q % 32 == 0:
            out.append((p, q, "long"))
    return out


def split_sweep(root: str, tag: str, lengths=SPLIT_SWEEP) -> dict:
    torch = _port(root)
    from repro_torch.kernels import fft_matmul as tfm
    from repro_torch.kernels import radix, split
    out = {"tag": tag, "root": os.path.abspath(root), "bytes": 256 << 20,
           "lengths": []}
    ruled = hasattr(split, "rule_factors")
    for dt, n in lengths:
        dtype = getattr(torch, dt)
        b = max(1, (256 << 20) // (n * dtype.itemsize))
        x = _lines(torch, dtype, b, n)
        lib = torch.fft.fft(x)
        rec = {"dtype": dt, "shape": [b, n],
               "path": radix.kernel_path(n, dtype),
               "plan": list(split.FACTORS[dtype].get(n, ())),
               "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
               "bound_ms": bound_ms(b, n, dtype.itemsize),
               "candidates": []}
        try:
            rec["err"] = scaled_err(tfm.fft_fourstep(x), lib)
            rec["ms"] = time_ms(lambda: tfm.fft_fourstep(x))
        except (ValueError, RuntimeError) as e:
            rec["path"], rec["ms"], rec["raised"] = "raises", None, str(e)
        for p, q, row in (_split_candidates(split, n, dtype) if ruled
                          else []):
            plan = split.SplitPlan(n, p, q, row)

            def run(plan=plan):
                return tfm._launch_split(x, None, inverse=False,
                                         pack_parts=None, plan=plan)
            rec["candidates"].append({
                "p": p, "q": q, "row_path": row,
                "err": scaled_err(run(), lib), "ms": time_ms(run)})
        del x, lib
        torch.cuda.empty_cache()
        cands = ", ".join(f"{c['p']} x {c['q']} {c['row_path']} "
                          f"{c['ms']:.4f} ({c['err']:.1e})"
                          for c in rec["candidates"])
        ms = "raises" if rec["ms"] is None else f"{rec['ms']:.4f} ms"
        print(f"[{tag}] split {dt} ({b}, {n}) {rec['path']} {rec['plan']}: "
              f"{ms}, torch.fft {rec['torch_fft_ms']:.4f}, bound "
              f"{rec['bound_ms']:.4f}; candidates: {cands}", flush=True)
        out["lengths"].append(rec)
    return out


def _general_candidates(split, n: int, dtype, most: int = 14) -> list:
    """The general plans' (P, Q, pass A's route) for N that ``splitgen``
    forces: every radix pass A and up to ``most`` dense ones, evenly
    spaced over the candidates in order of P."""
    cands = split.general_candidates(n, dtype)
    rad = [c for c in cands if c[2] == "radix"]
    den = [c for c in cands if c[2] == "dense"]
    if len(den) > most:
        den = [den[round(i * (len(den) - 1) / (most - 1))]
               for i in range(most)]
    return rad + den


def split_general(root: str, tag: str, lengths=SPLIT_GENERAL_SWEEP) -> dict:
    torch = _port(root)
    from repro_torch.kernels import dense
    from repro_torch.kernels import fft_matmul as tfm
    from repro_torch.kernels import radix, split
    out = {"tag": tag, "root": os.path.abspath(root), "bytes": 256 << 20,
           "lengths": []}
    ruled = hasattr(split, "general_candidates")
    for dt, n in lengths:
        dtype = getattr(torch, dt)
        b = max(1, (256 << 20) // (n * dtype.itemsize))
        x = _lines(torch, dtype, b, n)
        lib = torch.fft.fft(x)
        rec = {"dtype": dt, "shape": [b, n],
               "path": radix.kernel_path(n, dtype),
               "plan": (list(split.general_factors(n, dtype) or ())
                        if ruled else []),
               "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
               "bound_ms": bound_ms(b, n, dtype.itemsize),
               "candidates": []}
        try:
            rec["err"] = scaled_err(tfm.fft_fourstep(x), lib)
            rec["ms"] = time_ms(lambda: tfm.fft_fourstep(x))
        except (ValueError, RuntimeError) as e:
            rec["path"], rec["ms"], rec["raised"] = "raises", None, str(e)
        for p, q, col in (_general_candidates(split, n, dtype) if ruled
                          else []):
            plan = split.SplitPlan(n, p, q, "dense", col)

            def run(plan=plan):
                return tfm._launch_split(x, None, inverse=False,
                                         pack_parts=None, plan=plan)
            lines = (dense.column_plan(p, dtype).lines if col == "dense"
                     else None)
            rec["candidates"].append({
                "p": p, "q": q, "col_path": col, "col_lines": lines,
                "err": scaled_err(run(), lib), "ms": time_ms(run)})
        del x, lib
        torch.cuda.empty_cache()
        cands = ", ".join(f"{c['p']} x {c['q']} {c['col_path']} "
                          f"{c['ms']:.4f} ({c['err']:.1e})"
                          for c in rec["candidates"])
        ms = "raises" if rec["ms"] is None else f"{rec['ms']:.4f} ms"
        print(f"[{tag}] splitgen {dt} ({b}, {n}) {rec['path']} "
              f"{rec['plan']}: {ms}, torch.fft {rec['torch_fft_ms']:.4f}, "
              f"bound {rec['bound_ms']:.4f}; candidates: {cands}",
              flush=True)
        out["lengths"].append(rec)
    return out


def _m_candidates(chirp, radix, n: int, dtype) -> list:
    """The M that ``chirpm`` forces for N: of the 13-smooth M from 2N - 1
    to twice that, the least odd one, the least even one, the least
    multiple of 4, 16 and 64, the power of two, and the tree's own (the
    three least with a route, past one block's line)."""
    lo = 2 * n - 1
    smooth = [m for m in range(lo, 2 * lo + 1) if radix.smooth(m)] \
        if lo < 1 << 16 else [m for m in chirp._smooth_lengths()
                              if lo <= m <= 2 * lo]
    picks = {chirp.chirp_plan(n, dtype).m}
    for test in (lambda m: m % 2, lambda m: m % 2 == 0,
                 lambda m: m % 4 == 0, lambda m: m % 16 == 0,
                 lambda m: m % 64 == 0, radix.is_pow2):
        first = next((m for m in smooth if test(m)), None)
        if first is not None:
            picks.add(first)
    picks.update([m for m in smooth
                  if chirp.inner_plan(n, m, dtype) is not None][:3])
    return sorted(m for m in picks
                  if chirp.inner_plan(n, m, dtype) is not None)


def chirp_m(root: str, tag: str, lengths=CHIRP_SWEEP) -> dict:
    """The chirp route at each of ``lengths``, 256 MB of lines, with its M
    forced to each of :func:`_m_candidates` (``chirp.chirp_plan``
    answers that M's plan and ``radix.kernel_path`` the chirp for N
    alone), beside ``torch.fft.fft`` and the bound."""
    torch = _port(root)
    from repro_torch.kernels import chirp, radix
    from repro_torch.kernels import fft_matmul as tfm
    planned, routed = chirp.chirp_plan, radix.kernel_path
    out = {"tag": tag, "root": os.path.abspath(root), "bytes": 256 << 20,
           "lengths": []}
    for dt, n in lengths:
        dtype = getattr(torch, dt)
        b = max(1, (256 << 20) // (n * dtype.itemsize))
        x = _lines(torch, dtype, b, n)
        lib = torch.fft.fft(x)
        rec = {"dtype": dt, "shape": [b, n], "m": planned(n, dtype).m,
               "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
               "bound_ms": bound_ms(b, n, dtype.itemsize),
               "candidates": []}
        for m in _m_candidates(chirp, radix, n, dtype):
            plan = chirp.inner_plan(n, m, dtype)
            chirp.chirp_plan = (lambda k, d, plan=plan:
                                plan if k == n else planned(k, d))
            radix.kernel_path = (lambda k, d: "chirp" if k == n
                                 else routed(k, d))
            try:
                e = scaled_err(tfm.fft_fourstep(x), lib)
                ms = time_ms(lambda: tfm.fft_fourstep(x))
            finally:
                chirp.chirp_plan, radix.kernel_path = planned, routed
            sp = plan.split
            rec["candidates"].append({
                "m": m, "route": plan.route,
                "factors": [sp.p, sp.q] if sp is not None else None,
                "err": e, "ms": ms})
        del x, lib
        torch.cuda.empty_cache()
        cands = ", ".join(f"{c['m']} {c['route']} {c['ms']:.4f} "
                          f"({c['err']:.1e})" for c in rec["candidates"])
        print(f"[{tag}] chirpm {dt} ({b}, {n}) M={rec['m']}: torch.fft "
              f"{rec['torch_fft_ms']:.4f}, bound {rec['bound_ms']:.4f}; "
              f"candidates: {cands}", flush=True)
        out["lengths"].append(rec)
    return out


def _nested_candidates(split, n: int, dtype, most: int = 10) -> list:
    """The nested plans' (P, Q, pass A's route) for N that ``nested``
    forces: every radix pass A and up to ``most`` dense ones, evenly
    spaced over the candidates in order of P, and the tree's own."""
    cands = split.any_candidates(n, dtype)
    rad = [c for c in cands if c[2] == "radix"]
    den = [c for c in cands if c[2] == "dense"]
    if len(den) > most:
        den = [den[round(i * (len(den) - 1) / (most - 1))]
               for i in range(most)]
    own = split.nested_factors(n, dtype)
    return rad + den + ([own] if own not in rad + den else [])


def nested(root: str, tag: str, lengths=NESTED_SWEEP) -> dict:
    """The nested plans at each of ``lengths``, 512 MB of lines (one line
    past it): the tree's route, then each of :func:`_nested_candidates`
    forced, beside ``torch.fft.fft`` and the bound."""
    torch = _port(root)
    from repro_torch.kernels import fft_matmul as tfm
    from repro_torch.kernels import radix, split
    out = {"tag": tag, "root": os.path.abspath(root), "bytes": 512 << 20,
           "lengths": []}
    for dt, n in lengths:
        dtype = getattr(torch, dt)
        b = max(1, (512 << 20) // (n * dtype.itemsize))
        x = _lines(torch, dtype, b, n)
        lib = torch.fft.fft(x)
        rec = {"dtype": dt, "shape": [b, n],
               "path": radix.kernel_path(n, dtype),
               "plan": list(split.nested_factors(n, dtype) or ()),
               "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
               "bound_ms": bound_ms(b, n, dtype.itemsize),
               "candidates": []}
        rec["err"] = scaled_err(tfm.fft_fourstep(x), lib)
        rec["ms"] = time_ms(lambda: tfm.fft_fourstep(x))
        for p, q, col in _nested_candidates(split, n, dtype):
            plan = split.SplitPlan(n, p, q, "any", col)

            def run(plan=plan):
                return tfm._launch_split(x, None, inverse=False,
                                         pack_parts=None, plan=plan)
            rec["candidates"].append({
                "p": p, "q": q, "col_path": col,
                "row_path": split.row_route(q, dtype),
                "err": scaled_err(run(), lib), "ms": time_ms(run)})
        del x, lib
        torch.cuda.empty_cache()
        cands = ", ".join(f"{c['p']} x {c['q']} {c['col_path']}/"
                          f"{c['row_path']} {c['ms']:.4f} ({c['err']:.1e})"
                          for c in rec["candidates"])
        print(f"[{tag}] nested {dt} ({b}, {n}) {rec['path']} "
              f"{rec['plan']}: {rec['ms']:.4f} ms, torch.fft "
              f"{rec['torch_fft_ms']:.4f}, bound {rec['bound_ms']:.4f}; "
              f"candidates: {cands}", flush=True)
        out["lengths"].append(rec)
    return out


#: Build parts of ``wide``'s probe library, compiled at once.
PROBE_PARTS = 8


def _wide_plans(longline, n: int, dtype) -> list:
    """The wide plans of N that ``wide`` forces: the rule's pick
    (``longline.wide_candidates``' first), the best of another split, the
    pick's split with one line a tile and with the most lines, each
    once.  (The first sweep also forced 256 threads a block, the rule's
    pick then, before ``longline.WIDE_THREADS`` became 128: PERF.md §6.)"""
    cands = longline.wide_candidates(n, dtype)
    if not cands:
        return []
    best = cands[0]
    split = (best.r1, best.r2, best.r3)
    picks = [best,
             next((c for c in cands if (c.r1, c.r2, c.r3) != split), None),
             next((c for c in cands if (c.r1, c.r2, c.r3) == split
                   and c.lt == 1), None),
             max((c for c in cands if (c.r1, c.r2, c.r3) == split),
                 key=lambda c: c.lt)]
    out = []
    for c in picks:
        if c is not None and c not in out:
            out.append(c)
    return out


def _probe_build(root: str, radix_ns: list, plans: list,
                 timer=time.perf_counter):
    """A library of ``radix_launch`` for each (dtype, N) of ``radix_ns``
    and ``wide_launch`` for each wide plan of ``plans``, from the sources
    of the tree at ROOT (``fft_wide.cuh``), in :data:`PROBE_PARTS` units
    compiled at once; entry ``repro_probe_K(id, ...)`` of part K = id %
    PROBE_PARTS.  Returns (ctypes library, seconds, ptxas registers and
    spill bytes per wide plan)."""
    import ctypes
    from repro_torch.core.transforms import factorize
    from repro_torch.kernels import build
    csrc = os.path.join(os.path.abspath(root), "src", "repro_torch", "csrc")
    out_dir = os.path.join(os.path.abspath(root), "build", "wide_probe")
    os.makedirs(out_dir, exist_ok=True)
    cases = [[] for _ in range(PROBE_PARTS)]
    ids = len(radix_ns) + len(plans)
    for i in range(ids):
        if i < len(radix_ns):
            dt, n = radix_ns[i]
            r = "float" if dt == "complex64" else "double"
            n1, n2 = factorize(n)
            call = (f"repro_fft::radix_launch<{r}, {n1}, {n2}, "
                    f"repro_fft::kRadixPlain>(x, out, consts, tw, batch, 1, "
                    f"inverse, seg, lines_log2, 0, 0, smem_bytes, stream)")
        else:
            p = plans[i - len(radix_ns)]
            r = "float" if p.itemsize == 8 else "double"
            call = (f"repro_fft::wide_launch<{r}, {p.r1}, {p.r2}, {p.r3}, "
                    f"{p.lt}, {p.min_blocks}>(x, out, consts, tw, batch, "
                    f"inverse, seg, smem_bytes, stream)")
        cases[i % PROBE_PARTS].append(f"    case {i}: return {call};")
    procs, objs = [], []
    t0 = timer()
    for k in range(PROBE_PARTS):
        src = os.path.join(out_dir, f"probe{k}.cu")
        with open(src, "w") as f:
            f.write('#include "fft_wide.cuh"\nextern "C" int repro_probe_'
                    f'{k}(int id, const void* x, void* out, const void* '
                    'consts, const void* tw, long long batch, int inverse, '
                    'int seg, int lines_log2, int smem_bytes, void* s) {\n'
                    '  cudaStream_t stream = static_cast<cudaStream_t>(s);\n'
                    '  switch (id) {\n' + "\n".join(cases[k])
                    + '\n  }\n  return (int)cudaErrorInvalidValue;\n}\n')
        obj = src[:-3] + ".o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [build.nvcc_path(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", csrc, "-c",
             "-o", obj, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    log = "".join(proc.communicate()[0] for proc in procs)
    if any(proc.returncode for proc in procs):
        sys.exit(f"route_times: the probe did not build:\n{log[-20000:]}")
    lib_path = os.path.join(out_dir, "libprobe.so")
    subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, "-shared", "-o",
                    lib_path, *objs], check=True)
    seconds = timer() - t0
    lib = ctypes.CDLL(lib_path)
    v, i_, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for k in range(PROBE_PARTS):
        fn = getattr(lib, f"repro_probe_{k}")
        fn.argtypes = [i_, v, v, v, v, ll, i_, i_, i_, i_, v]
        fn.restype = i_
    regs = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if "wide_kernel" in m.group(1) else None
            continue
        if cur is None:
            continue
        m = re.search(r"wide_kernelI([fd])((?:Li\d+E){5})", cur)
        key = (m.group(1),) + tuple(int(a) for a in re.findall(
            r"Li(\d+)E", m.group(2))) if m else cur
        rec = regs.setdefault(key, {})
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rec["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            rec["stack"] = int(m.group(1))
    return lib, seconds, regs


def _wide_all(root: str) -> tuple:
    """(dtype name, N) of every wide line of the tree at ROOT
    (``longline.WIDE``)."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    from repro_torch.kernels import longline
    return tuple((str(dtype).removeprefix("torch."), n)
                 for dtype, plans in longline.WIDE.items()
                 for n in sorted(plans))


def _settle(torch, what: str, seconds: float = 30.0,
            timer=time.monotonic) -> None:
    """Wait for the card to finish what was launched, but end the process
    if it takes longer than ``seconds`` (a kernel that never ends: its
    context goes with the process)."""
    done = torch.cuda.Event()
    done.record()
    deadline = timer() + seconds
    while not done.query():
        if timer() > deadline:
            print(f"route_times: {what} did not finish in {seconds} s",
                  flush=True)
            os._exit(3)
        time.sleep(0.01)


def _split_plans(longline, n: int, dtype) -> list:
    """For ``widesplits``: every split of N in both orders (R1 below R2
    too, which ``longline.wide_candidates`` leaves out), R3 a power of two
    to ``WIDE_R3_MAX``, rows of ``WIDE_ROW_MIN_BYTES``, each at the tile
    the rule's key ranks first for it."""
    from repro_torch.kernels import radix
    size, out = dtype.itemsize, []
    for r3 in (16, 8, 4, 2):
        if r3 > longline.WIDE_R3_MAX or n % r3:
            continue
        for r1 in range(2, longline.PASS_MAX + 1):
            r2 = n // r3 // r1
            if (n // r3) % r1 or not 2 <= r2 <= longline.PASS_MAX \
                    or not (radix.codelet_length(r1)
                            and radix.codelet_length(r2)) \
                    or r2 * r3 * size < longline.WIDE_ROW_MIN_BYTES:
                continue
            want = 65536 // (longline.WIDE_THREADS
                             * longline._WIDE_REGS[size])
            tiles = []
            for lt in range(1, longline.WIDE_LT_MAX + 1):
                p = longline.WidePlan(n, r1, r2, r3, lt, size)
                if lt > 1 and (p.min_blocks < want or p.smem_bytes
                               > radix.SMEM_MAX_BYTES):
                    break
                tiles.append(p)
            out.append(min(tiles, key=longline._wide_key))
    return out


#: (dtype name, N) of ``widesplits``: every complex128 wide line, and the
#: complex64 ones whose picks spilled or trailed in ``wideall`` (PERF.md
#: §6), with a few others.
WIDE_SPLITS = tuple(("complex64", n) for n in (
    1056, 1120, 1260, 1320, 1400, 1500, 1620, 2160, 2400, 2520, 2880,
    3000, 1092, 2944, 4032, 3600))


def wide(root: str, tag: str, lengths=WIDE_SWEEP, picker=None) -> dict:
    """``radix_kernel`` and the wide kernel's plans (:func:`_wide_plans`)
    forced on the same lines at 512 MB, from one probe build of the tree
    at ROOT, beside ``torch.fft.fft`` and the bound; each plan also
    checked against ``longline.emulate`` of that plan on a ragged batch,
    inverse, with the output twiddle and ``pack_parts``."""
    torch = _port(root)
    from repro_torch.kernels import fft_matmul as tfm
    from repro_torch.kernels import longline, radix
    todo = []
    for dt, n in lengths:
        dtype = getattr(torch, dt)
        todo.append((dt, n, (picker or _wide_plans)(longline, n, dtype)))
    radix_ns = [(dt, n) for dt, n, _ in todo]
    plans = [p for _, _, ps in todo for p in ps]
    lib, seconds, regs = _probe_build(root, radix_ns, plans)
    print(f"[{tag}] probe: {len(radix_ns)} radix and {len(plans)} wide "
          f"instantiations in {seconds:.2f} s", flush=True)
    out = {"tag": tag, "root": os.path.abspath(root), "bytes": 512 << 20,
           "probe_seconds": seconds, "lengths": []}
    pid = 0

    def call(i, *args):
        err = getattr(lib, f"repro_probe_{i % PROBE_PARTS}")(i, *args)
        if err:
            raise RuntimeError(f"probe {i}: CUDA error {err}")

    def wide_runner(i, p, x, inverse=False, tw=None, parts=1):
        b, n = x.shape
        consts = torch.from_numpy(longline.constants(
            n, x.dtype, inverse, p)).to("cuda", x.dtype)
        buf = torch.empty((parts, b, n // parts), dtype=x.dtype,
                          device="cuda")

        def run():
            call(i, x.data_ptr(), buf.data_ptr(), consts.data_ptr(),
                 None if tw is None else tw.data_ptr(), b, int(inverse),
                 n // parts, 0, p.smem_bytes,
                 torch.cuda.current_stream().cuda_stream)
            return buf
        return run

    for k, (dt, n, ps) in enumerate(todo):
        dtype = getattr(torch, dt)
        b = (512 << 20) // (n * dtype.itemsize)
        x = _lines(torch, dtype, b, n)
        ref = torch.fft.fft(x)
        tile = radix.radix_tile(n, dtype.itemsize, False, False)
        rconsts = tfm._radix_constants(n, False, dtype, x.device)
        rout = torch.empty_like(x)

        def run_radix(k=k):
            call(k, x.data_ptr(), rout.data_ptr(), rconsts.data_ptr(),
                 None, b, 0, tfm._seg_arg(n, 1), tile.lines.bit_length() - 1,
                 tile.smem_bytes, torch.cuda.current_stream().cuda_stream)
        run_radix()
        _settle(torch, f"radix {dt} {n}")
        rec = {"dtype": dt, "shape": [b, n],
               "path": radix.kernel_path(n, dtype),
               "radix_err": scaled_err(rout, ref),
               "radix_ms": time_ms(run_radix),
               "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
               "bound_ms": bound_ms(b, n, dtype.itemsize), "plans": []}
        gen = torch.Generator(device="cuda").manual_seed(n + 1)
        runs = []
        for p in ps:
            i = len(radix_ns) + pid
            pid += 1
            key = ("f" if p.itemsize == 8 else "d", p.r1, p.r2, p.r3, p.lt,
                   p.min_blocks)
            run = wide_runner(i, p, x)
            y = run()[0]
            _settle(torch, f"wide plan {p}")
            # a ragged batch, inverse, twiddle and pack_parts
            small = x[:2 * p.lt + 1]
            tw = torch.randn(n, dtype=dtype, device="cuda", generator=gen)
            parts = 4 if n % 4 == 0 else 1
            got = wide_runner(i, p, small, True, tw, parts)()
            want = longline.emulate(small, inverse=True, twiddle=tw,
                                    pack_parts=parts, plan=p)
            if parts == 1:
                want = want.reshape(got.shape)
            prec = {"r": [p.r1, p.r2, p.r3], "lt": p.lt,
                    "threads": p.threads, "min_blocks": p.min_blocks,
                    "fill": p.fill, "smem_bytes": p.smem_bytes,
                    "ptxas": regs.get(key, {}),
                    "err": scaled_err(y, ref),
                    "plain_err": scaled_err(got, want),
                    "ms": time_ms(run)}
            rec["plans"].append(prec)
            runs.append(run)
            del y
        # the second readings in the reverse order: radix, plans, plans
        # reversed, radix
        for prec, run in zip(rec["plans"][::-1], runs[::-1]):
            prec["ms_again"] = time_ms(run)
        rec["radix_ms_again"] = time_ms(run_radix)
        del x, ref, rout, runs
        torch.cuda.empty_cache()
        cands = ", ".join(
            f"{c['r']} lt{c['lt']} t{c['threads']} b{c['min_blocks']} "
            f"{c['ms']:.4f} / {c['ms_again']:.4f} ({c['err']:.1e}/{c['plain_err']:.1e} "
            f"r{c['ptxas'].get('registers')} s{c['ptxas'].get('spill_bytes')})"
            for c in rec["plans"])
        print(f"[{tag}] wide {dt} ({b}, {n}): radix {rec['radix_ms']:.4f} / "
              f"{rec['radix_ms_again']:.4f} ms, torch.fft {rec['torch_fft_ms']:.4f}, bound "
              f"{rec['bound_ms']:.4f}; plans: {cands}", flush=True)
        out["lengths"].append(rec)
    return out


def wide_check(root: str, tag: str) -> dict:
    """``times`` at :data:`WIDE_CHECK` and :data:`WIDE_KEPT` (512 MB of
    lines, each on the tree's own route), then the strided entry at
    :data:`WIDE_STRIDED` and the C2C plans of :data:`WIDE_GRIDS` on the
    kernel backend (launches per route, line copies), beside ``fftn``."""
    shapes = tuple((dt, (512 << 20) // (n * (8 if dt == "complex64"
                                              else 16)), n)
                   for dt, n in WIDE_CHECK + WIDE_KEPT)
    out = times(root, tag, shapes, plan=False)
    import torch
    from repro_torch import make_mesh, plan_fft
    from repro_torch.kernels import fft_matmul as tfm
    from repro_torch.kernels import ops
    out["strided"], out["plans"] = [], []
    for dt, shape, axis in WIDE_STRIDED:
        x = torch.randn(shape, dtype=getattr(torch, dt), device="cuda")
        block = x.movedim(axis, 1).contiguous()
        y = tfm.fft_fourstep_strided(block)
        rec = {"dtype": dt, "shape": list(shape), "axis": axis,
               "err_vs_torch_fft": scaled_err(
                   y, torch.fft.fft(block, dim=1)),
               "ms": time_ms(lambda: tfm.fft_fourstep_strided(block)),
               "torch_fft_ms": time_ms(lambda: torch.fft.fft(block, dim=1)),
               "bound_ms": bound_ms(x.numel() // shape[axis], shape[axis],
                                    x.element_size())}
        print(f"[{tag}] strided {dt} {shape}: {rec['ms']:.4f} ms, "
              f"torch.fft {rec['torch_fft_ms']:.4f}, bound "
              f"{rec['bound_ms']:.4f}; vs torch.fft "
              f"{rec['err_vs_torch_fft']:.2e}", flush=True)
        out["strided"].append(rec)
        del x, block, y
    mesh = make_mesh((1, 1), ("data", "model"))
    for grid in WIDE_GRIDS:
        plan = plan_fft(mesh, grid, backend="kernel")
        x = torch.randn(grid, dtype=torch.complex64, device="cuda")
        tfm.reset_launch_counts()
        ops.copies["lines"] = 0
        y = plan.forward(x)
        torch.cuda.synchronize()
        rec = {"grid": list(grid),
               "launches": dict(tfm.fft_fourstep.path_launches),
               "copies": ops.copies["lines"],
               "err_vs_fftn": scaled_err(y, torch.fft.fftn(x)),
               "fwd_ms": time_ms(lambda: plan.forward(x), 5),
               "fftn_ms": time_ms(lambda: torch.fft.fftn(x), 5)}
        print(f"[{tag}] plan {grid}: forward {rec['fwd_ms']:.4f} ms, fftn "
              f"{rec['fftn_ms']:.4f}; vs fftn {rec['err_vs_fftn']:.2e}; "
              f"launches {rec['launches']}, line copies {rec['copies']}",
              flush=True)
        out["plans"].append(rec)
        del x, y
    return out


def _line(recs: list):
    """Least squares of the dense route's ms = a + b*s over ``recs``."""
    k = len(recs)
    sx = sum(r["s"] for r in recs)
    sy = sum(r["dense_ms"] for r in recs)
    sxx = sum(r["s"] ** 2 for r in recs)
    sxy = sum(r["s"] * r["dense_ms"] for r in recs)
    b = (k * sxy - sx * sy) / (k * sxx - sx * sx)
    return (sy - b * sx) / k, b


def fit(paths) -> dict:
    """The constants of ``dense.takes``' rule and of the chirp's M from
    ``generic`` and ``chirpm`` runs (their OUT.json files): per dtype and
    length the mean of the ``generic`` runs and their spread; per dtype,
    least squares of the dense route's ms = a + b*s over the even N whose
    generic primes sum to at most 300 and apart over the odd N, and the
    chirp's ms per element of M (ms * N / M) over both kinds of run: the
    mean on the long-line route and on a split plan, and on the dense
    route's kernel least squares of a base per tile (lines sharing a
    block or one a block), a weight per stage of M's chain and one per
    share of a block's shared memory a line fills; in units of the even
    N's b, ``dense.GENERIC_COST``'s (base, weight) per parity and its
    chirp costs.  Then the lengths that this
    checkout's ``radix.kernel_path`` sends to the slower of the two
    routes, and, per ``chirpm`` length, how far the M this checkout's
    ``chirp.chirp_plan`` picks is from the fastest forced."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), os.pardir, "src"))
    import torch
    from repro_torch.kernels import chirp, radix
    import numpy as np
    from repro_torch.kernels import dense
    rows, samples, forced = {}, [], []
    for path in paths:
        with open(path) as f:
            for r in json.load(f)["lengths"]:
                n = r["shape"][1]
                if "candidates" in r:               # chirpm
                    forced.append(r)
                    samples.extend((r["dtype"], c["route"], c["m"] / n,
                                    c["ms"]) for c in r["candidates"])
                    continue
                e = rows.setdefault((r["dtype"], n), dict(
                    s=r["s"], m=r["m"], m_path=r.get("m_path"), dense=[],
                    chirp=[]))
                e["dense"].append(r["dense_ms"])
                e["chirp"].append(r["chirp_ms"])
                samples.append((r["dtype"], r.get("m_path"), r["m"] / n,
                                r["chirp_ms"]))
    out = {"runs": list(paths), "lengths": [], "constants": {},
           "moved_slower": [], "kept_slower": [], "m_picks": []}
    for (dt, n), e in rows.items():
        for key in ("dense", "chirp"):
            v = e[key]
            e[f"{key}_ms"] = sum(v) / len(v)
            e[f"{key}_spread"] = (max(v) - min(v)) / e[f"{key}_ms"]
        e["path"] = radix.kernel_path(n, getattr(torch, dt))
        out["lengths"].append(dict(e, dtype=dt, n=n))
    for dt in sorted({dt for dt, _ in rows}):
        mine = [r for r in out["lengths"] if r["dtype"] == dt]
        even = [r for r in mine if r["n"] % 2 == 0 and r["s"] <= 300]
        a, b = _line(even)
        odd = [r for r in mine if r["n"] % 2 and r["s"] <= 300]
        a_odd, b_odd = _line(odd)
        # the chirp's ms per element of M (ms * N / M): a constant on the
        # long-line route and on a split plan; on the dense route's kernel
        # a base per tile (lines sharing a block, or one line a block)
        # plus a weight per stage of M's chain and one per share of the
        # SM's shared memory that a line of M fills
        cost = {}
        for k in ("long", "split"):
            ys = [y / x for d, c, x, y in samples if d == dt and c == k]
            if ys:
                cost[k] = sum(ys) / len(ys)
        cdt = getattr(torch, dt)
        mat, vec = [], []
        for r in forced + [dict(e, dtype=dd, n=nn)
                           for (dd, nn), e in rows.items()]:
            if r["dtype"] != dt:
                continue
            n = r["shape"][1] if "shape" in r else r["n"]
            pts = ([(c["m"], c["ms"]) for c in r["candidates"]
                    if c["route"] == "dense"] if "candidates" in r else
                   [(r["m"], r["chirp_ms"])] if r.get("m_path", "dense")
                   == "dense" and "chirp_ms" in r else [])
            for m, ms in pts:
                share = dense.dense_plan(m, cdt).lines > 1
                mat.append([float(share), float(not share),
                            float(len(dense.chain(m))),
                            m * cdt.itemsize / radix.SMEM_MAX_BYTES])
                vec.append(ms * n / m)
        if mat:
            coef = np.linalg.lstsq(np.array(mat), np.array(vec),
                                   rcond=None)[0]
            (cost["share"], cost["line"], cost["stage"],
             cost["fill"]) = (float(c) for c in coef)
            err = np.array(mat) @ coef / np.array(vec) - 1
            out["constants"].setdefault(dt, {})
            print(f"[fit] {dt}: the chirp's dense M, {len(vec)} points: "
                  f"error {err.min():+.3f} to {err.max():+.3f}, rms "
                  f"{float(np.sqrt((err ** 2).mean())):.3f}")
        out["constants"][dt] = {
            "a_ms": a, "b_ms": b, "a_odd_ms": a_odd, "b_odd_ms": b_odd,
            "even": [a / b, 1.0], "odd": [a_odd / b, b_odd / b],
            "chirp": {k: c / b for k, c in cost.items()}}
        print(f"[fit] {dt}: dense ms = {a:.4f} + {b:.5f}*s (even N), "
              f"{a_odd:.4f} + {b_odd:.5f}*s (odd N); in units of "
              f"{b:.5f} ms: even base {a / b:.2f}, odd base "
              f"{a_odd / b:.2f} and weight {b_odd / b:.3f}; chirp cost "
              f"per element of M " + ", ".join(f"{k} {c / b:.2f}"
                                                for k, c in cost.items()))
    for r in sorted(out["lengths"], key=lambda r: (r["dtype"], r["n"])):
        best = min(r["dense_ms"], r["chirp_ms"])
        print(f"[fit] {r['dtype']} {r['n']} s={r['s']} M={r['m']}: dense "
              f"{r['dense_ms']:.4f} ms (spread {r['dense_spread']:.3f}), "
              f"chirp {r['chirp_ms']:.4f} ({r['chirp_spread']:.3f}); "
              f"routed {r['path']}")
        if r["path"] in ("dense", "chirp") and r[f"{r['path']}_ms"] > best:
            key = "moved_slower" if r["path"] == "chirp" else "kept_slower"
            out[key].append([r["dtype"], r["n"],
                             r[f"{r['path']}_ms"] / best - 1])
    for r in forced:
        n, dtype = r["shape"][1], getattr(torch, r["dtype"])
        pick = chirp.chirp_plan(n, dtype).m
        best = min(r["candidates"], key=lambda c: c["ms"])
        mine = next((c for c in r["candidates"] if c["m"] == pick), None)
        off = None if mine is None else mine["ms"] / best["ms"] - 1
        out["m_picks"].append([r["dtype"], n, pick, best["m"], off])
        print(f"[fit] chirp {r['dtype']} {n}: picks M={pick}, fastest "
              f"forced M={best['m']} {best['route']} {best['ms']:.4f} ms; "
              f"the pick {'not forced' if off is None else f'{off:+.1%}'}")
    print(f"[fit] moved to the chirp and slower there (by how much): "
          f"{out['moved_slower']}")
    print(f"[fit] kept on the dense route though the chirp was faster: "
          f"{out['kept_slower']}")
    return out


def _split_pass(name: str) -> str:
    """The split route's pass a kernel (by its name in the profiler,
    demangled or not) belongs to: "A", "rows" or "C"."""
    if "transpose" in name:
        return "C"
    radix_mode = re.search(r"radix_kernel(?:<[^,]+, \d+, \d+, |I[fd]Li\d+E"
                           r"Li\d+ELi)(\d)", name)
    if "dense_column" in name or (radix_mode and radix_mode.group(1) == "1"):
        return "A"
    return "rows"


def split_passes(root: str, tag: str, lengths=SPLIT_PASSES,
                 iters: int = 10) -> dict:
    torch = _port(root)
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import fft_matmul as tfm
    from repro_torch.kernels import radix, split
    out = {"tag": tag, "root": os.path.abspath(root), "lengths": []}
    for dt, n, mb in lengths:
        dtype = getattr(torch, dt)
        b = max(1, (mb << 20) // (n * dtype.itemsize))
        x = _lines(torch, dtype, b, n)
        plan = split.split_plan(n, dtype)
        tfm.reset_launch_counts()
        lib = torch.fft.fft(x)
        rec = {"dtype": dt, "shape": [b, n],
               "path": radix.kernel_path(n, dtype),
               "plan": [plan.p, plan.q, plan.row_path, plan.col_path],
               "err_vs_torch_fft": scaled_err(tfm.fft_fourstep(x), lib),
               "launches": dict(tfm.fft_fourstep.path_launches),
               "ms": time_ms(lambda: tfm.fft_fourstep(x)),
               "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
               "bound_ms": bound_ms(b, n, dtype.itemsize)}
        del lib
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                tfm.fft_fourstep(x)
            torch.cuda.synchronize()
        passes, kernels = {"A": 0.0, "rows": 0.0, "C": 0.0}, []
        for a in prof.key_averages():
            us = getattr(a, "self_device_time_total",
                         getattr(a, "self_cuda_time_total", 0.0))
            if us <= 0 or not str(a.device_type).endswith("CUDA"):
                continue
            which = _split_pass(a.key)
            passes[which] += us * 1e-3 / iters
            kernels.append({"name": a.key[:100], "pass": which,
                            "calls": a.count / iters,
                            "ms": us * 1e-3 / iters})
        rec.update(pass_ms=passes, kernels=kernels)
        del x
        torch.cuda.empty_cache()
        print(f"[{tag}] splitpasses {dt} ({b}, {n}) as {plan.p} x {plan.q} "
              f"(rows {plan.row_path}, pass A {plan.col_path}): "
              f"{rec['ms']:.4f} ms; pass A {passes['A']:.4f}, rows "
              f"{passes['rows']:.4f}, pass C {passes['C']:.4f}; torch.fft "
              f"{rec['torch_fft_ms']:.4f}, bound {rec['bound_ms']:.4f}; vs "
              f"torch.fft {rec['err_vs_torch_fft']:.2e}; launches "
              f"{rec['launches']['split']}", flush=True)
        out["lengths"].append(rec)
    return out


def _fold_layouts(split, dense, plan, dtype) -> list:
    """The folded pass B's layouts ``splitfold`` forces for ``plan``: the
    tree's own first, then C of 1 to 8 blocks (a divisor of P on long
    rows); on dense rows C = 1 with one or two slots, C > 1 pushed into
    the tiles (one slot)."""
    import dataclasses
    own = split.fold_layout(plan, dtype)
    if own is None:
        return []
    out = [own]
    for c in (1, 2, 4, 8):
        if own.rows == "long":
            if plan.p % c == 0 and c != own.cluster:
                out.append(dataclasses.replace(own, cluster=c))
            continue
        for depth in ((1, 2) if c == 1 else (1,)):
            lay = split.dense_fold(plan, dtype, c, depth)
            if lay is not None and lay not in out:
                out.append(lay)
    return out


def split_fold(root: str, tag: str, lengths=SPLIT_PASSES) -> dict:
    torch = _port(root)
    from repro_torch.kernels import dense
    from repro_torch.kernels import fft_matmul as tfm
    from repro_torch.kernels import split
    out = {"tag": tag, "root": os.path.abspath(root), "lengths": []}
    for dt, n, mb in lengths:
        dtype = getattr(torch, dt)
        plan = split.split_plan(n, dtype)
        layouts = _fold_layouts(split, dense, plan, dtype)
        if not layouts:
            continue
        b = max(1, (mb << 20) // (n * dtype.itemsize))
        x = _lines(torch, dtype, b, n)
        lib = torch.fft.fft(x)
        rec = {"dtype": dt, "shape": [b, n], "plan": [plan.p, plan.q],
               "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
               "bound_ms": bound_ms(b, n, dtype.itemsize), "layouts": []}
        for lay in layouts:
            def run(lay=lay):
                return tfm._launch_split(x, None, inverse=False,
                                         pack_parts=None, plan=plan,
                                         fold=lay)
            rec["layouts"].append({
                "cluster": lay.cluster, "lines": lay.lines,
                "depth": lay.depth, "threads": lay.threads,
                "tile_pitch": lay.tile_pitch, "smem_bytes": lay.smem_bytes,
                "err": scaled_err(run(), lib), "ms": time_ms(run)})
        del x, lib
        torch.cuda.empty_cache()
        print(f"[{tag}] splitfold {dt} ({b}, {n}) as {plan.p} x {plan.q}: "
              f"torch.fft {rec['torch_fft_ms']:.4f}, bound "
              f"{rec['bound_ms']:.4f}; " + ", ".join(
                  f"C{r['cluster']} L{r['lines']} d{r['depth']} "
                  f"{'push' if r['tile_pitch'] else 'own'} "
                  f"t{r['threads']} {r['ms']:.4f} ({r['err']:.1e})"
                  for r in rec["layouts"]), flush=True)
        out["lengths"].append(rec)
    return out


#: (dtype name, N, MB of lines) that ``generalrules`` times on each
#: tree's own route after the general lengths: the wide lines c64 2400 =
#: 25x24x4 and 2000 = 25x20x4 (``wide_kernel``, whose SASS moved when
#: ``mixed_tiles`` gained the split's store), the nested c64 3^16 = 2187 x
#: 19683 (dense rows too long for the folded kernel's slot and tile) and
#: chirps over split plans of M with such rows (c64 8388617, c128 2^21 +
#: 1).
RULES_SHAPES = (("complex64", 2400, 512), ("complex64", 2000, 512),
                ("complex64", 3 ** 16, 512), ("complex64", 8388617, 512),
                ("complex128", (1 << 21) + 1, 512))
#: (GENERAL_P, GENERAL_Q_MAX, dense when no radix pass A fits) per
#: complex64 rule that ``generalrules`` forces; complex128 halves P and
#: the longest Q (the same bytes).  The first is the rule before the
#: folded rows (complex64's since); shorter rows keep two or three folded
#: blocks an SM (complex128's since: 200, 1750).
GENERAL_RULES = ((400, 7500, False), (400, 5500, False),
                 (400, 4500, False), (400, 3500, False),
                 (400, 2500, False), (400, 4500, True),
                 (400, 3500, True), (1000, 4500, True))


def _rule_pick(split, n: int, dtype, target: int, qmax: int,
               dense_next: bool) -> tuple:
    """``split.general_factors``' pick under other constants: a radix pass
    A at its least P whose Q is at most ``qmax`` (with ``dense_next``,
    only where one is; else the dense family as if N had none), else at
    its shortest Q; else the dense P whose Q is at most that nearest
    ``target`` in ratio, else the shortest Q."""
    cands = split.general_candidates(n, dtype)
    rad = [c for c in cands if c[2] == "radix"]
    if rad and (not dense_next or any(c[1] <= qmax for c in rad)):
        fits = [c for c in rad if c[1] <= qmax]
        return fits[0] if fits else min(rad, key=lambda c: c[1])
    family = [c for c in cands if c[2] == "dense"] or rad
    fits = [c for c in family if c[1] <= qmax]
    if not fits:
        return min(family, key=lambda c: c[1])
    return min(fits, key=lambda c: (abs(math.log(c[0] / target)), c[0]))


def general_rules(root: str, tag: str) -> dict:
    torch = _port(root)
    from repro_torch.kernels import fft_matmul as tfm
    from repro_torch.kernels import radix, split
    out = {"tag": tag, "root": os.path.abspath(root), "lengths": []}
    folded = hasattr(split, "fold_layout")
    cases = ([(dt, n, 256, True) for dt, n in SPLIT_GENERAL_SWEEP
              + SPLIT_GENERAL_CHECK]
             + [(dt, n, mb, False) for dt, n, mb in RULES_SHAPES])
    for dt, n, mb, general in cases:
        dtype = getattr(torch, dt)
        b = max(1, (mb << 20) // (n * dtype.itemsize))
        x = _lines(torch, dtype, b, n)
        lib = torch.fft.fft(x)
        tfm.reset_launch_counts()
        rec = {"dtype": dt, "shape": [b, n], "general": general,
               "held_out": (dt, n) in SPLIT_GENERAL_CHECK,
               "path": radix.kernel_path(n, dtype),
               "err_vs_torch_fft": scaled_err(tfm.fft_fourstep(x), lib),
               "launches": tfm.launch_counts()["launches"],
               "ms": time_ms(lambda: tfm.fft_fourstep(x)),
               "torch_fft_ms": time_ms(lambda: torch.fft.fft(x)),
               "bound_ms": bound_ms(b, n, dtype.itemsize), "rules": []}
        if rec["path"] == "split":
            plan = split.split_plan(n, dtype)
            rec["plan"] = [plan.p, plan.q, plan.row_path, plan.col_path]
        timed = {}
        for target, qmax, dense_next in (GENERAL_RULES if general and folded
                                         else ()):
            scale = 1 if dtype == torch.complex64 else 2
            p, q, col = _rule_pick(split, n, dtype, target // scale,
                                   qmax // scale, dense_next)
            if (p, q, col) not in timed:
                plan = split.SplitPlan(n, p, q, "dense", col)
                if split.fold_layout(plan, dtype) is None:
                    plan = split.SplitPlan(n, p, q, "any", col)

                def run(plan=plan):
                    return tfm._launch_split(x, None, inverse=False,
                                             pack_parts=None, plan=plan)
                timed[p, q, col] = {"err": scaled_err(run(), lib),
                                    "ms": time_ms(run),
                                    "row_path": plan.row_path}
            rec["rules"].append({"p_target": target, "q_max": qmax,
                                 "dense_next": dense_next,
                                 "plan": [p, q, col], **timed[p, q, col]})
        del x, lib
        torch.cuda.empty_cache()
        rules = ", ".join(f"{r['plan'][0]} x {r['plan'][1]} {r['ms']:.4f}"
                          for r in rec["rules"])
        print(f"[{tag}] generalrules {dt} ({b}, {n}) {rec['path']} "
              f"{rec.get('plan', '')}: {rec['ms']:.4f} ms "
              f"({rec['err_vs_torch_fft']:.1e}, {rec['launches']} "
              f"launches), torch.fft {rec['torch_fft_ms']:.4f}, bound "
              f"{rec['bound_ms']:.4f}" + (f"; rules: {rules}" if rules
                                          else ""), flush=True)
        out["lengths"].append(rec)
    return out


def _cuobjdump() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    return cand if os.path.exists(cand) else shutil.which("cuobjdump")


def _sass(path: str) -> dict:
    listing = subprocess.run([_cuobjdump(), "-sass", path],
                             capture_output=True, text=True,
                             check=True).stdout
    funcs, cur = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f_]+", "ANON", m.group(1))
            funcs[cur] = []
        elif cur is not None and "/* 0x" in line:
            # an instruction or its encoding; the module headers between
            # functions (cuobjdump prints no end of a function) are not
            line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
            funcs[cur].append(" ".join(line.split()))
    return funcs


def sass(old: str, new: str) -> dict:
    a, b = _sass(old), _sass(new)
    common = [k for k in a if k in b]
    changed = [k for k in common if a[k] != b[k]]
    out = {"old": len(a), "new": len(b), "kept": len(common) - len(changed),
           "changed": changed, "missing": [k for k in a if k not in b],
           "added": len(b) - len(common),
           "old_lines": sum(map(len, a.values())),
           "new_lines": sum(map(len, b.values()))}
    print(f"[sass] {out['old']} functions before, {out['new']} after: "
          f"{out['kept']} kept their bodies, {len(changed)} changed, "
          f"{len(out['missing'])} missing, {out['added']} added")
    return out


def main(argv) -> int:
    if len(argv) == 5 and argv[1] == "times":
        result = times(argv[2], argv[3])
    elif len(argv) == 5 and argv[1] == "timescheck":
        result = times(argv[2], argv[3], CHECK_SHAPES, plan=False)
    elif len(argv) == 4 and argv[1] == "sweep":
        result = sweep(argv[2])
    elif len(argv) == 4 and argv[1] == "generic":
        result = generic(argv[2])
    elif len(argv) == 4 and argv[1] == "check":
        result = generic(argv[2], GENERIC_CHECK)
    elif len(argv) >= 4 and argv[1] == "fit":
        result = fit(argv[2:-1])
    elif len(argv) == 5 and argv[1] == "split":
        result = split_sweep(argv[2], argv[3])
    elif len(argv) == 5 and argv[1] == "splitcheck":
        result = split_sweep(argv[2], argv[3], SPLIT_CHECK)
    elif len(argv) == 5 and argv[1] == "splitgen":
        result = split_general(argv[2], argv[3])
    elif len(argv) == 5 and argv[1] == "splitgencheck":
        result = split_general(argv[2], argv[3], SPLIT_GENERAL_CHECK)
    elif len(argv) == 5 and argv[1] == "chirpm":
        result = chirp_m(argv[2], argv[3])
    elif len(argv) == 5 and argv[1] == "chirpmcheck":
        result = chirp_m(argv[2], argv[3], CHIRP_CHECK)
    elif len(argv) == 5 and argv[1] == "nested":
        result = nested(argv[2], argv[3])
    elif len(argv) == 5 and argv[1] == "nestedcheck":
        result = nested(argv[2], argv[3], NESTED_CHECK)
    elif len(argv) == 5 and argv[1] == "wide":
        result = wide(argv[2], argv[3])
    elif len(argv) == 5 and argv[1] == "wideall":
        result = wide(argv[2], argv[3], _wide_all(argv[2]))
    elif len(argv) == 5 and argv[1] == "widepicks":
        result = wide(argv[2], argv[3], _wide_all(argv[2]),
                      lambda ll, n, dt: ll.wide_candidates(n, dt)[:1])
    elif len(argv) == 5 and argv[1] == "widesplits":
        result = wide(argv[2], argv[3], WIDE_SPLITS + tuple(
            e for e in _wide_all(argv[2]) if e[0] == "complex128"),
            _split_plans)
    elif len(argv) == 5 and argv[1] == "widecheck":
        result = wide_check(argv[2], argv[3])
    elif len(argv) == 5 and argv[1] == "splitpasses":
        result = split_passes(argv[2], argv[3])
    elif len(argv) == 5 and argv[1] == "splitfold":
        result = split_fold(argv[2], argv[3])
    elif len(argv) == 5 and argv[1] == "generalrules":
        result = general_rules(argv[2], argv[3])
    elif len(argv) == 5 and argv[1] == "sass":
        result = sass(argv[2], argv[3])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    with open(argv[-1], "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
