"""Nh3D benchmark gold-standard generation (CATH-architecture level).

Copy of cuda_satabsearch_tpu/eval/nh3d.py (that package imports jax).

The Nh3D data set (Thiruv et al. 2005, BMC Struct Biol 5:12) is an
all-against-all benchmark of 805 CATH topology representatives; the
gold standard for a query is every entry sharing its CATH
*architecture* (the first two components, C.A), or — with class-level
evaluation — its class (reference: scripts/rocrnh3d.py:44-49,
scripts/tsevalnh3d.py).

Structure identifiers in search results use the reference's
'compressed' form: the CATH id with the dots removed (the reference's
Fortran core limited ids to 8 characters; scripts/cathmap.py).  The
compression is not invertible by parsing, so the full topology list is
carried here (CATH nomenclature data, grouped by architecture) and the
compressed->full map derived from it.

The 73 queries are the ones tabulated by Pelta et al. 2008 (BMC
Bioinformatics 9:161, Additional File 1), as in rocrnh3d.py:50.
"""

from __future__ import annotations

# CATH topology ids of the Nh3D v3.0 set, grouped as
# "class.arch:topology topology ..." (one group per architecture).
_NH3D_TOPOLOGIES = """\
1.10:10 100 1000 101 1020 1030 1040 1060 1070 1080 1090 110 1130 1140 \
1160 1170 12 120 1200 1240 1270 1280 1290 1300 132 1320 1340 135 1350 \
1360 1370 1380 140 1400 1410 1420 1450 150 1500 1510 1520 1530 155 \
1580 1610 162 164 1650 166 1660 167 1670 1680 1710 1750 1760 1780 \
1790 1820 183 1830 1840 1860 1870 189 1900 20 2000 2080 2090 210 220 \
225 230 238 239 240 245 246 260 274 275 285 286 287 288 290 30 300 \
3030 3040 3050 3100 3130 3140 3190 3200 3210 3250 3270 3280 340 357 \
375 390 40 400 405 418 420 422 437 439 440 441 442 443 45 455 460 465 \
468 472 489 490 494 506 510 520 530 532 533 540 555 565 569 575 579 \
580 590 599 60 600 606 620 630 640 645 700 710 720 730 740 750 760 \
790 8 800 820 840 890 910 940 950
1.20:1000 1050 1060 1070 1080 1090 1120 1150 1170 1180 120 1200 1220 \
1250 1260 1270 1280 1290 1330 1350 1370 140 141 1410 142 1430 144 \
1460 150 190 200 210 225 245 272 5 50 58 59 80 810 82 840 85 870 89 \
90 900 91 910 920 930 940 950 970 990
1.25:10 20 40
1.40:10
1.50:10 30
2.10:109 150 22 25 260 270 50 55 60 69 70 77 90
2.20:100 110 120 25 26 28 50 80 90
2.30:110 120 130 140 170 18 210 220 230 27 29 30 31 34 37 38 39 40 42 \
60 70
2.40:10 100 110 128 15 150 155 160 170 180 20 200 220 230 240 260 280 \
290 30 300 310 33 340 37 40 50 70
2.50:10 20
2.60:11 110 120 130 15 175 20 200 210 220 240 250 260 270 290 30 320 \
330 34 340 350 360 390 40 410 420 60 90 98
2.70:100 130 160 170 180 20 220 240 250 40 50 70 9 98
2.80:10
2.90:10
2.100:10
2.102:10 20
2.105:10
2.110:10
2.115:10
2.120:10
2.130:10
2.140:10
2.150:10
2.160:10 20
2.170:11 130 150 16 160 170 190 200 220 230 240 270 280 290 40 8 9
3.10:10 100 105 110 120 129 130 150 170 180 196 20 200 25 250 260 270 \
28 290 300 310 320 330 340 390 400 440 450 460 490 50
3.15:10 20
3.20:10 100 110 120 130 140 16 19 20 70 80 90
3.30:10 1010 1020 1030 1040 1050 1060 110 1110 1120 1130 1150 1160 \
1180 1220 1230 1240 1270 1280 1300 1310 1330 1340 1360 1370 1380 1390 \
1400 1430 1440 1450 1460 1480 1490 1500 1520 1530 1540 1560 1570 1590 \
160 1600 1620 1650 1660 1670 1690 170 1700 1720 1750 1760 1770 1780 \
190 20 200 210 230 240 250 280 30 300 310 350 360 365 370 379 380 386 \
387 390 40 410 413 420 428 429 43 430 44 450 457 46 460 465 470 479 \
497 499 50 500 505 519 530 538 540 559 56 560 565 572 590 60 63 66 67 \
70 700 710 740 750 760 830 870 9 900 920 930 950 990
3.40:1000 1010 1030 1050 1060 1080 109 1090 1120 1130 1140 1160 1170 \
1180 1190 120 1210 1230 1280 1310 1340 1350 1360 1370 1380 1390 140 \
1400 1410 1420 1440 1450 1470 1490 1500 1510 1520 1530 1540 1550 1560 \
190 192 198 20 210 220 225 228 250 30 309 33 35 350 366 367 390 395 \
420 430 440 449 462 47 470 50 532 570 580 600 605 630 640 710 718 720 \
80 800 810 830 850 91 920 930 950 960 970 980
3.50:20 30 4 50 7 70 80
3.55:10 20 30
3.60:10 100 110 120 130 140 15 20 21 40 70 9 90
3.65:10
3.70:10
3.75:10
3.80:10
3.90:10 1000 1010 1020 105 1070 110 1140 1150 1160 1170 1180 120 1200 \
1210 1230 1240 1260 1280 1290 1300 1310 132 1320 1330 1340 1350 1390 \
1430 1470 1480 15 1520 1530 1550 1570 1580 1600 1630 1640 170 175 176 \
180 182 190 198 20 209 210 215 220 226 228 230 245 249 25 260 280 310 \
320 330 340 350 370 380 39 390 400 420 440 45 450 460 470 480 50 510 \
540 55 550 570 580 600 640 660 670 70 700 730 740 75 76 770 78 780 79 \
80 800 840 850 870 900 910 920 930 940 950 960 970 980
3.100:10
4.10:10 1020 1070 1080 1090 110 160 220 260 270 280 372 375 410 420 \
450 470 480 490 520 530 540 550 70 740 790 8 800 870 91 93 940 95 950 \
960 990"""

# Query CATH ids (Pelta et al. 2008 Additional File 1; rocrnh3d.py:50)
NH3D_QUERIES = (
    "1.10.1040 1.10.1320 1.10.533 1.10.645 1.20.1280 1.20.210 1.20.5 "
    "1.20.840 2.10.25 2.10.260 2.10.270 2.10.90 2.170.16 2.170.230 "
    "2.170.290 2.170.40 2.30.110 2.30.18 2.30.230 2.30.29 2.30.40 "
    "2.40.155 2.40.160 2.40.180 2.40.340 2.40.50 2.60.130 2.60.260 "
    "2.60.420 2.60.90 2.70.100 2.70.180 2.70.220 2.70.98 3.10.105 "
    "3.10.170 3.10.270 3.10.330 3.10.400 3.20.120 3.20.140 3.20.19 "
    "3.20.70 3.20.90 3.30.1530 3.30.1690 3.30.240 3.30.559 3.30.560 "
    "3.30.60 3.30.990 3.40.1210 3.40.1380 3.40.225 3.40.720 3.60.100 "
    "3.60.120 3.60.20 3.60.40 3.60.90 3.90.1280 3.90.1300 3.90.1350 "
    "3.90.1580 3.90.510 3.90.850 4.10.1080 4.10.1090 4.10.220 "
    "4.10.260 4.10.480 4.10.540 4.10.790").split()


def all_cath_ids() -> list[str]:
    """Full 'C.A.T' ids of every Nh3D entry."""
    out = []
    for group in _NH3D_TOPOLOGIES.split("\n"):
        ca, tops = group.split(":")
        out.extend(f"{ca}.{t}" for t in tops.split())
    return out


def compress(cath_id: str) -> str:
    """'1.10.1040' -> '1101040' (the 8-char result-file identifier)."""
    return cath_id.replace(".", "")


def cathmap() -> dict[str, str]:
    """compressed id -> full CATH id (scripts/cathmap.py equivalent,
    derived rather than stored)."""
    return {compress(i): i for i in all_cath_ids()}


def architecture(cath_id: str) -> str:
    return ".".join(cath_id.split(".")[:2])


def cath_class(cath_id: str) -> str:
    return cath_id.split(".")[0]


def nh3d_gold(level: str = "arch") -> dict[str, set[str]]:
    """Gold standard {compressed query id: set of compressed positive
    ids}: positives share the query's CATH architecture ('arch') or
    class ('class'), themselves included (rocrnh3d.py semantics; its
    -c flag selects class level)."""
    if level == "arch":
        keyf = architecture
    elif level == "class":
        keyf = cath_class
    else:
        raise ValueError(f"level must be 'arch' or 'class', got {level!r}")
    ids = all_cath_ids()
    groups: dict[str, set[str]] = {}
    for i in ids:
        groups.setdefault(keyf(i), set()).add(compress(i))
    return {compress(q): groups[keyf(q)] for q in NH3D_QUERIES}


def write_nh3d_gold(path: str, level: str = "arch") -> None:
    """Emit the gold standard in the eval CLI's file format."""
    gold = nh3d_gold(level)
    with open(path, "w") as fh:
        fh.write(f"# Nh3D gold standard, CATH {level} level\n")
        for qid in sorted(gold):
            fh.write(" ".join([qid] + sorted(gold[qid])) + "\n")
