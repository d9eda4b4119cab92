"""Fischer-1996 benchmark tables and gold-standard generation.

Copy of cuda_satabsearch_tpu/eval/fischer.py (that package imports jax).

The 68-probe Fischer data set (Fischer et al. 1996, Pac. Symp.
Biocomput. 300-318; fold/class assignments as tabulated by Pelta et
al. 2008, BMC Bioinformatics 9:161) is the reference's primary
accuracy benchmark (scripts/fischer_tables.py, scripts/rocrfischer.py:
the gold standard for a query is every probe sharing its fold — or,
with class-level evaluation, its class).

This module carries the published probe->fold and probe->class data
tables and derives everything else (the reference also stores the
inverted fold->ids / class->ids dicts; here they are computed).
"""

from __future__ import annotations

# probe id -> (fold, class); Fischer 1996 Table II (obsoleted PDB ids
# replaced as in the benchmark's later uses)
FISCHER_TABLE: dict[str, tuple[str, str]] = {
    "1dxt_b": ("globin-like", "alpha"),
    "1cpc_l": ("globin-like", "alpha"),
    "1c2r_a": ("cytochrome", "alpha"),
    "2mta_c": ("cytochrome", "alpha"),
    "1bbh_a": ("helical bundle", "alpha"),
    "1bge_b": ("helical bundle", "alpha"),
    "1rcb": ("helical bundle", "alpha"),
    "1aep": ("helical bundle", "alpha"),
    "1osa": ("ef-hand", "alpha"),
    "2sas": ("ef-hand", "alpha"),
    "1hom": ("other alpha", "alpha"),
    "1lga_a": ("other alpha", "alpha"),
    "2hpd_a": ("other alpha", "alpha"),
    "1chr_a": ("tim barrel", "alpha/beta"),
    "2mnr": ("tim barrel", "alpha/beta"),
    "3rub_l": ("tim barrel", "alpha/beta"),
    "1crl": ("hydrolase", "alpha/beta"),
    "1tah_a": ("hydrolase", "alpha/beta"),
    "1aba": ("thieredoxin", "alpha/beta"),
    "1dsb_a": ("thieredoxin", "alpha/beta"),
    "1gpl_a": ("thieredoxin", "alpha/beta"),
    "1atn_a": ("ribonuclease", "alpha/beta"),
    "1hrh_a": ("ribonuclease", "alpha/beta"),
    "3chy": ("open sheet", "alpha/beta"),
    "2ak3_a": ("open sheet", "alpha/beta"),
    "1gky": ("open sheet", "alpha/beta"),
    "2cmd": ("open sheet", "alpha/beta"),
    "1eaf": ("open sheet", "alpha/beta"),
    "2gbp": ("open sheet", "alpha/beta"),
    "1mio_c": ("open sheet", "alpha/beta"),
    "2pia": ("open sheet", "alpha/beta"),
    "1gal": ("open sheet", "alpha/beta"),
    "1npx": ("open sheet", "alpha/beta"),
    "2hhm_a": ("mixed", "other"),
    "1hip": ("small", "other"),
    "1isu_a": ("small", "other"),
    "1fc1_a": ("ig", "beta"),
    "2fbj_l": ("ig", "beta"),
    "1cid": ("ig-like", "beta"),
    "1pfc": ("ig-like", "beta"),
    "1ten": ("ig-like", "beta"),
    "1tlk": ("ig-like", "beta"),
    "3cd4": ("ig-like", "beta"),
    "3hla_b": ("ig-like", "beta"),
    "1aaj": ("copredoxin", "beta"),
    "2afn_a": ("copredoxin", "beta"),
    "2aza_a": ("copredoxin", "beta"),
    "4sbv_a": ("virus", "beta"),
    "1bbt_1": ("virus", "beta"),
    "1sac_a": ("lectin-like", "beta"),
    "1lts_d": ("ob-fold", "beta"),
    "1tie": ("trefoil", "beta"),
    "8i1b": ("trefoil", "beta"),
    "1arb": ("trypsin", "beta"),
    "2sga": ("trypsin", "beta"),
    "2snv": ("trypsin", "beta"),
    "1mdc": ("lipocalin", "beta"),
    "1mup": ("lipocalin", "beta"),
    "2sim": ("propeller", "beta"),
    "1cau_b": ("other beta", "beta"),
    "2omf": ("other beta", "beta"),
    "1fxi_a": ("ub fold", "alpha+beta"),
    "1cew": ("cystatin", "alpha+beta"),
    "1stf_i": ("cystatin", "alpha+beta"),
    "2pna": ("sh2", "alpha+beta"),
    "2sar_a": ("other alpha+beta", "alpha+beta"),
    "1onc": ("other alpha+beta", "alpha+beta"),
    "5fd1": ("other alpha+beta", "alpha+beta"),
}

FISCHER_ID_FOLD = {k: v[0] for k, v in FISCHER_TABLE.items()}
FISCHER_ID_CLASS = {k: v[1] for k, v in FISCHER_TABLE.items()}


def _invert(id_to_group: dict[str, str]) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    for pid, grp in id_to_group.items():
        out.setdefault(grp, []).append(pid)
    return out


FISCHER_FOLD_IDS = _invert(FISCHER_ID_FOLD)
FISCHER_CLASS_IDS = _invert(FISCHER_ID_CLASS)


def fischer_gold(level: str = "fold") -> dict[str, set[str]]:
    """Gold standard {query id: positive ids} at 'fold' or 'class'
    level: the positives for a probe are all probes in its fold
    (class), itself included — matching the reference's rocrfischer.py
    goldstd_ids selection (:144-168)."""
    if level == "fold":
        groups, members = FISCHER_ID_FOLD, FISCHER_FOLD_IDS
    elif level == "class":
        groups, members = FISCHER_ID_CLASS, FISCHER_CLASS_IDS
    else:
        raise ValueError(f"level must be 'fold' or 'class', got {level!r}")
    return {pid: set(members[groups[pid]]) for pid in groups}


def write_fischer_gold(path: str, level: str = "fold") -> None:
    """Emit the gold standard in the eval CLI's file format."""
    gold = fischer_gold(level)
    with open(path, "w") as fh:
        fh.write(f"# Fischer-1996 gold standard, {level} level\n")
        for pid in sorted(gold):
            fh.write(" ".join([pid] + sorted(gold[pid])) + "\n")
