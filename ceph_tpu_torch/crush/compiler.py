"""CRUSH text-map compiler/decompiler (CrushCompiler analog).

The port's own copy of ``ceph_tpu/crush/compiler.py``: the same data and code,
so a map carried across by the wire form (``encoding``) maps identically
in both packages.

Speaks the reference's text crushmap format so maps interoperate with
``crushtool -d/-c`` (grammar reference:src/crush/grammar.h:118-137,
compile reference:src/crush/CrushCompiler.cc:351-760, decompile
reference:src/crush/CrushCompiler.cc:57-330):

    # begin crush map
    tunable choose_total_tries 50
    device 0 osd.0
    type 0 osd
    type 1 host
    host host0 {
        id -1
        alg straw2
        hash 0  # rjenkins1
        item osd.0 weight 1.000
    }
    rule replicated_ruleset {
        ruleset 0
        type replicated
        min_size 1
        max_size 10
        step take default
        step chooseleaf firstn 0 type host
        step emit
    }
    # end crush map

The reference parses with a boost::spirit grammar; here a line
tokenizer is enough — the language is line-oriented apart from bucket
and rule bodies, which are brace-delimited.
"""

from __future__ import annotations

from .map import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_NOOP,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE,
    RULE_TYPE_ERASURE,
    RULE_TYPE_REPLICATED,
    CrushMap,
    Rule,
    Tunables,
)

ALG_NAMES = {
    CRUSH_BUCKET_UNIFORM: "uniform",
    CRUSH_BUCKET_LIST: "list",
    CRUSH_BUCKET_TREE: "tree",
    CRUSH_BUCKET_STRAW: "straw",
    CRUSH_BUCKET_STRAW2: "straw2",
}
ALG_IDS = {v: k for k, v in ALG_NAMES.items()}

HASH_NAMES = {0: "rjenkins1"}

# tunable name -> (Tunables attr, legacy default); only non-legacy values
# are printed, mirroring reference:CrushCompiler.cc:188-205
TUNABLES = {
    "choose_local_tries": ("choose_local_tries", 2),
    "choose_local_fallback_tries": ("choose_local_fallback_tries", 5),
    "choose_total_tries": ("choose_total_tries", 19),
    "chooseleaf_descend_once": ("chooseleaf_descend_once", 0),
    "chooseleaf_vary_r": ("chooseleaf_vary_r", 0),
    "chooseleaf_stable": ("chooseleaf_stable", 0),
    "straw_calc_version": ("straw_calc_version", 0),
}

_SET_STEPS = {
    "set_choose_tries": CRUSH_RULE_SET_CHOOSE_TRIES,
    "set_choose_local_tries": CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries": CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_tries": CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    "set_chooseleaf_vary_r": CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": CRUSH_RULE_SET_CHOOSELEAF_STABLE,
}
_SET_STEP_NAMES = {v: k for k, v in _SET_STEPS.items()}

_CHOOSE_OPS = {
    ("choose", "firstn"): CRUSH_RULE_CHOOSE_FIRSTN,
    ("choose", "indep"): CRUSH_RULE_CHOOSE_INDEP,
    ("chooseleaf", "firstn"): CRUSH_RULE_CHOOSELEAF_FIRSTN,
    ("chooseleaf", "indep"): CRUSH_RULE_CHOOSELEAF_INDEP,
}
_CHOOSE_NAMES = {v: k for k, v in _CHOOSE_OPS.items()}


class CrushCompileError(ValueError):
    pass


def _fixedpoint(w: int) -> str:
    """reference:CrushCompiler.cc:57 — %.3f of w/0x10000."""
    return f"{w / 0x10000:.3f}"


# --------------------------------------------------------------------------
# decompile
# --------------------------------------------------------------------------

def decompile_crushmap(m: CrushMap) -> str:
    out: list[str] = ["# begin crush map"]
    t = m.tunables
    for key, (attr, legacy) in TUNABLES.items():
        val = getattr(t, attr)
        if val != legacy:
            out.append(f"tunable {key} {val}")

    out.append("")
    out.append("# devices")
    for d in range(m.max_devices):
        line = f"device {d} {m.item_names.get(d, f'osd.{d}')}"
        cls = m.device_class(d) if hasattr(m, "device_class") else None
        if cls:
            line += f" class {cls}"
        out.append(line)

    out.append("")
    out.append("# types")
    for tid in sorted(m.type_names):
        out.append(f"type {tid} {m.type_names[tid]}")

    out.append("")
    out.append("# buckets")
    emitted: set[int] = set()

    def emit_bucket(bid: int) -> None:
        if bid in emitted:
            return
        b = m.buckets[bid]
        for item in b.items:
            if item < 0:
                emit_bucket(item)  # children first (the decompiler's DAG walk)
        emitted.add(bid)
        tname = m.type_names.get(b.type, f"type{b.type}")
        bname = m.item_names.get(bid, f"bucket{-1 - bid}")
        out.append(f"{tname} {bname} {{")
        out.append(f"\tid {bid}\t\t# do not change unnecessarily")
        out.append(f"\t# weight {_fixedpoint(b.weight)}")
        out.append(f"\talg {ALG_NAMES[b.alg]}")
        out.append(f"\thash {b.hash}\t# {HASH_NAMES.get(b.hash, '?')}")
        dopos = b.alg == CRUSH_BUCKET_TREE
        for j, item in enumerate(b.items):
            iname = (
                m.item_names.get(item, f"osd.{item}")
                if item >= 0
                else m.item_names.get(item, f"bucket{-1 - item}")
            )
            w = _item_weight(b, j)
            line = f"\titem {iname} weight {_fixedpoint(w)}"
            if dopos:
                line += f" pos {j}"
            out.append(line)
        out.append("}")

    for bid in sorted(m.buckets, reverse=True):  # -1, -2, ...
        if m.shadow_parent(bid) is not None:
            continue  # shadow trees are derived state, never printed
        emit_bucket(bid)

    out.append("")
    out.append("# rules")
    for ruleno, r in enumerate(m.rules):
        if r is None:
            continue
        rname = getattr(m, "rule_names", {}).get(ruleno, f"rule{ruleno}")
        out.append(f"rule {rname} {{")
        out.append(f"\truleset {r.ruleset}")
        if r.type == RULE_TYPE_REPLICATED:
            out.append("\ttype replicated")
        elif r.type == RULE_TYPE_ERASURE:
            out.append("\ttype erasure")
        else:
            out.append(f"\ttype {r.type}")
        out.append(f"\tmin_size {r.min_size}")
        out.append(f"\tmax_size {r.max_size}")
        for s in r.steps:
            if s.op == CRUSH_RULE_NOOP:
                out.append("\tstep noop")
            elif s.op == CRUSH_RULE_EMIT:
                out.append("\tstep emit")
            elif s.op in _SET_STEP_NAMES:
                out.append(f"\tstep {_SET_STEP_NAMES[s.op]} {s.arg1}")
            elif s.op in _CHOOSE_NAMES:
                verb, mode = _CHOOSE_NAMES[s.op]
                tname = m.type_names.get(s.arg2, f"type{s.arg2}")
                out.append(f"\tstep {verb} {mode} {s.arg1} type {tname}")
            elif s.op == CRUSH_RULE_TAKE:
                owner = m.shadow_parent(s.arg1)
                if owner is not None:
                    orig, cid = owner
                    oname = m.item_names.get(orig, f"bucket{-1 - orig}")
                    out.append(
                        f"\tstep take {oname} class {m.class_names[cid]}"
                    )
                else:
                    iname = m.item_names.get(s.arg1, f"bucket{-1 - s.arg1}")
                    out.append(f"\tstep take {iname}")
            else:
                raise CrushCompileError(f"cannot decompile step op {s.op}")
        out.append("}")

    out.append("")
    out.append("# end crush map")
    return "\n".join(out) + "\n"


def _item_weight(b, j: int) -> int:
    if b.alg == CRUSH_BUCKET_UNIFORM:
        return b.item_weight
    if b.alg == CRUSH_BUCKET_TREE:
        return b.node_weights[2 * j + 1]
    return b.item_weights[j]


# --------------------------------------------------------------------------
# compile
# --------------------------------------------------------------------------

def compile_crushmap(text: str) -> CrushMap:
    """Parse the text form into a CrushMap (rebuilding derived bucket
    state through the builder, as the reference does)."""
    toks = _tokenize(text)
    m = CrushMap(Tunables.legacy())
    m.rule_names = {}
    m.type_names = {}
    item_id: dict[str, int] = {}
    # buckets are built through make_bucket so list sums / tree nodes /
    # straws regenerate
    try:
        _compile_toks(m, toks, item_id)
    except IndexError:
        raise CrushCompileError("unexpected end of input") from None
    if 0 not in m.type_names:
        m.type_names[0] = "osd"
    return m


def _compile_toks(
    m: CrushMap, toks: list[str], item_id: dict[str, int]
) -> None:
    pos = 0
    while pos < len(toks):
        tok = toks[pos]
        if tok == "tunable":
            name, val = toks[pos + 1], int(toks[pos + 2])
            pos += 3
            if name in TUNABLES:
                setattr(m.tunables, TUNABLES[name][0], val)
            # unknown tunables are ignored, like the reference's -> warning
        elif tok == "device":
            did, name = int(toks[pos + 1]), toks[pos + 2]
            pos += 3
            item_id[name] = did
            if not name.startswith("device"):
                m.item_names[did] = name
            if pos < len(toks) and toks[pos] == "class":
                m.set_device_class(did, toks[pos + 1])
                pos += 2
        elif tok == "type":
            tid, name = int(toks[pos + 1]), toks[pos + 2]
            pos += 3
            m.type_names[tid] = name
        elif tok == "rule":
            pos = _parse_rule(m, toks, pos, item_id)
        elif tok in _type_ids(m):
            pos = _parse_bucket(m, toks, pos, item_id)
        else:
            raise CrushCompileError(f"unexpected token {tok!r}")


def _type_ids(m: CrushMap) -> dict[str, int]:
    return {v: k for k, v in m.type_names.items()}


def _tokenize(text: str) -> list[str]:
    toks: list[str] = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        line = line.replace("{", " { ").replace("}", " } ")
        toks.extend(line.split())
    return toks


def _expect(toks: list[str], pos: int, want: str) -> int:
    if pos >= len(toks) or toks[pos] != want:
        got = toks[pos] if pos < len(toks) else "<eof>"
        raise CrushCompileError(f"expected {want!r}, got {got!r}")
    return pos + 1


def _parse_bucket(
    m: CrushMap, toks: list[str], pos: int, item_id: dict[str, int]
) -> int:
    tname, bname = toks[pos], toks[pos + 1]
    btype = _type_ids(m)[tname]
    pos = _expect(toks, pos + 2, "{")
    bucket_id: int | None = None
    alg: int | None = None
    hash_ = 0
    items: list[tuple[str, int, int | None]] = []  # (name, weight16, pos)
    while toks[pos] != "}":
        key = toks[pos]
        if key == "id":
            bucket_id = int(toks[pos + 1])
            pos += 2
        elif key == "alg":
            try:
                alg = ALG_IDS[toks[pos + 1]]
            except KeyError:
                raise CrushCompileError(f"unknown alg {toks[pos + 1]!r}")
            pos += 2
        elif key == "hash":
            h = toks[pos + 1]
            hash_ = 0 if h == "rjenkins1" else int(h)
            pos += 2
        elif key == "item":
            iname = toks[pos + 1]
            pos += 2
            w = 0x10000
            ipos: int | None = None
            while toks[pos] in ("weight", "pos"):
                if toks[pos] == "weight":
                    w = int(round(float(toks[pos + 1]) * 0x10000))
                else:
                    ipos = int(toks[pos + 1])
                pos += 2
            items.append((iname, w, ipos))
        else:
            raise CrushCompileError(f"unexpected bucket token {key!r}")
    pos += 1  # }
    if alg is None:
        raise CrushCompileError(f"bucket {bname} has no alg")
    # honor explicit pos (tree buckets): place into slots
    n = len(items)
    slots: list[tuple[str, int] | None] = [None] * n
    loose = []
    for iname, w, ipos in items:
        if ipos is not None:
            if ipos >= n:
                slots.extend([None] * (ipos + 1 - n))
                n = ipos + 1
            slots[ipos] = (iname, w)
        else:
            loose.append((iname, w))
    for i in range(len(slots)):
        if slots[i] is None and loose:
            slots[i] = loose.pop(0)
    resolved_items, weights = [], []
    for slot in slots:
        if slot is None:
            continue
        iname, w = slot
        if iname not in item_id:
            raise CrushCompileError(f"bucket {bname}: unknown item {iname!r}")
        resolved_items.append(item_id[iname])
        weights.append(w)
    bid = m.make_bucket(alg, btype, resolved_items, weights,
                        bucket_id=bucket_id, name=bname)
    if hash_:
        m.buckets[bid].hash = hash_
    item_id[bname] = bid
    return pos


def _parse_rule(
    m: CrushMap, toks: list[str], pos: int, item_id: dict[str, int]
) -> int:
    rname = toks[pos + 1]
    pos = _expect(toks, pos + 2, "{")
    r = Rule(ruleset=0)
    while toks[pos] != "}":
        key = toks[pos]
        if key == "ruleset":
            r.ruleset = int(toks[pos + 1])
            pos += 2
        elif key == "type":
            t = toks[pos + 1]
            r.type = (
                RULE_TYPE_REPLICATED if t == "replicated"
                else RULE_TYPE_ERASURE if t == "erasure"
                else int(t)
            )
            pos += 2
        elif key == "min_size":
            r.min_size = int(toks[pos + 1])
            pos += 2
        elif key == "max_size":
            r.max_size = int(toks[pos + 1])
            pos += 2
        elif key == "step":
            verb = toks[pos + 1]
            if verb == "noop":
                r.step(CRUSH_RULE_NOOP)
                pos += 2
            elif verb == "emit":
                r.step(CRUSH_RULE_EMIT)
                pos += 2
            elif verb == "take":
                iname = toks[pos + 2]
                if iname not in item_id:
                    raise CrushCompileError(f"step take: unknown {iname!r}")
                target = item_id[iname]
                pos += 3
                if pos < len(toks) and toks[pos] == "class":
                    cname = toks[pos + 1]
                    pos += 2
                    # rules follow buckets in the text form, so the
                    # shadow forest can be materialized on first use
                    if not m.class_bucket:
                        m.populate_classes()
                    try:
                        target = m.class_shadow(target, cname)
                    except KeyError as e:
                        raise CrushCompileError(str(e)) from None
                r.step(CRUSH_RULE_TAKE, target)
            elif verb in _SET_STEPS:
                r.step(_SET_STEPS[verb], int(toks[pos + 2]))
                pos += 3
            elif verb in ("choose", "chooseleaf"):
                mode = toks[pos + 2]
                if (verb, mode) not in _CHOOSE_OPS:
                    raise CrushCompileError(f"bad step {verb} {mode}")
                num = int(toks[pos + 3])
                p2 = _expect(toks, pos + 4, "type")
                tname = toks[p2]
                tid = _type_ids(m).get(tname)
                if tid is None:
                    raise CrushCompileError(f"unknown type {tname!r}")
                r.step(_CHOOSE_OPS[(verb, mode)], num, tid)
                pos = p2 + 1
            else:
                raise CrushCompileError(f"unknown step {verb!r}")
        else:
            raise CrushCompileError(f"unexpected rule token {key!r}")
    pos += 1
    ruleno = m.add_rule(r)
    m.rule_names[ruleno] = rname
    return pos
