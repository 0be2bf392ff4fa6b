"""crushtool: compile/inspect/test CRUSH maps from the command line.

Counterpart of ``ceph_tpu/tools/crushtool.py``, with one flag more:
``--device`` (default ``cuda``; ``cpu`` runs the batched path's plain
torch versions on the host), where ``--test`` maps its inputs.

The reference tool (reference:src/tools/crushtool.cc) compiles text maps,
builds simple hierarchies, and bulk-simulates placement with --test
(reference:crushtool.cc:341,:276 wiring CrushTester). The map file format
here is the framework's JSON wire form (ceph_tpu_torch.crush.encoding)
instead of the boost::spirit text grammar.

Text-format interop (reference:src/crush/CrushCompiler.cc) lives in
ceph_tpu_torch.crush.compiler: ``-c map.txt`` compiles the reference text
grammar, ``-d map.json`` decompiles to it; ``-i``/``-o`` take either
form (files ending .txt/.map are treated as text).

Usage:
  crushtool --build N [--weight W] -o map.json
  crushtool -c map.txt -o map.json       # compile text -> wire form
  crushtool -d map.json [-o map.txt]     # decompile -> text
  crushtool -i map.json --tree
  crushtool -i map.json --test [--num-rep N] [--min-x A] [--max-x B]
            [--rule R] [--show-utilization] [--show-mappings] [--scalar]
            [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

from ..crush.compiler import compile_crushmap, decompile_crushmap
from ..crush.encoding import crush_from_dict, crush_to_dict
from ..crush.map import CrushMap
from ..crush.tester import CrushTester


def _is_text(path: str) -> bool:
    return path.endswith((".txt", ".map"))


def _load(path: str) -> CrushMap:
    with open(path) as f:
        if _is_text(path):
            return compile_crushmap(f.read())
        return crush_from_dict(json.load(f))


def _save(cmap: CrushMap, path: str) -> None:
    with open(path, "w") as f:
        if _is_text(path):
            f.write(decompile_crushmap(cmap))
        else:
            json.dump(crush_to_dict(cmap), f, indent=1)


def _tree(cmap: CrushMap, out) -> None:
    weights = cmap.get_weights()
    for bid in sorted(cmap.buckets, reverse=True):
        b = cmap.buckets[bid]
        name = cmap.item_names.get(bid, f"bucket{bid}")
        tname = cmap.type_names.get(b.type, str(b.type))
        print(f"{bid}\t{tname} {name}\talg={b.alg} size={b.size}", file=out)
        for item, w in zip(b.items, b.item_weights):
            label = (
                cmap.item_names.get(item, f"osd.{item}")
                if item >= 0
                else cmap.item_names.get(item, f"bucket{item}")
            )
            print(f"\t{item}\t{label}\tweight {w / 0x10000:.5f}", file=out)
    print(f"devices: {cmap.max_devices}", file=out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="crushtool", description=__doc__)
    p.add_argument("-i", "--infn", help="input map (JSON wire or text form)")
    p.add_argument("-o", "--outfn", help="output map file")
    p.add_argument("-c", "--compile", metavar="SRC",
                   help="compile a text crushmap")
    p.add_argument("-d", "--decompile", metavar="SRC",
                   help="decompile a map to text (stdout unless -o)")
    p.add_argument("--build", type=int, metavar="N",
                   help="build a flat N-device straw2 map")
    p.add_argument("--weight", type=float, default=1.0)
    p.add_argument("--tree", action="store_true", help="print the hierarchy")
    p.add_argument("--test", action="store_true", help="bulk placement sim")
    p.add_argument("--rule", type=int, default=None)
    p.add_argument("--num-rep", type=int, default=None)
    p.add_argument("--min-x", type=int, default=0)
    p.add_argument("--max-x", type=int, default=1023)
    p.add_argument("--show-utilization", action="store_true")
    p.add_argument("--show-mappings", action="store_true")
    p.add_argument("--scalar", action="store_true",
                   help="force the scalar mapper (skip the batched path)")
    p.add_argument("--device", default="cuda",
                   help="torch device the batched path runs on (cuda or cpu)")
    args = p.parse_args(argv)
    out = sys.stdout

    if args.build is not None:
        cmap = CrushMap.flat(args.build, weight=args.weight)
        cmap.add_simple_rule(cmap.root_id(), 0)
        cmap.add_simple_rule(cmap.root_id(), 0, indep=True)
    elif args.compile:
        if not args.outfn and not (args.tree or args.test):
            p.error("-c needs -o <outfile> (or --tree/--test)")
        with open(args.compile) as f:
            cmap = compile_crushmap(f.read())
    elif args.decompile:
        cmap = _load(args.decompile)
        if not args.outfn:
            out.write(decompile_crushmap(cmap))
    elif args.infn:
        cmap = _load(args.infn)
    else:
        p.error("need -i <map>, -c/-d <map>, or --build N")

    if args.tree:
        _tree(cmap, out)

    if args.test:
        tester = CrushTester(cmap, device=args.device)
        tester.min_x, tester.max_x = args.min_x, args.max_x
        tester.force_scalar = args.scalar
        if args.rule is not None:
            tester.ruleset = args.rule
        if args.num_rep is not None:
            tester.min_rep = tester.max_rep = args.num_rep
        for rep in tester.test():
            rate = rep.num_inputs / rep.elapsed_seconds
            print(
                f"rule {rep.rule} num_rep {rep.numrep} "
                f"{rep.num_inputs} inputs in {rep.elapsed_seconds:.3f}s "
                f"({rate:,.0f} mappings/s, {rep.backend}) "
                f"bad_mappings {rep.bad_mappings}",
                file=out,
            )
            if args.show_utilization:
                for dev in sorted(rep.device_counts):
                    expect = rep.expected_per_device.get(dev, 0.0)
                    print(
                        f"  device {dev}: stored {rep.device_counts[dev]} "
                        f"expected {expect:.1f}",
                        file=out,
                    )
            if args.show_mappings:
                from ..crush import mapper

                ws = mapper.Workspace(cmap)
                for x in range(args.min_x, min(args.max_x, args.min_x + 31) + 1):
                    res = mapper.crush_do_rule(
                        cmap, rep.rule, x, rep.numrep, workspace=ws
                    )
                    print(f"  CRUSH rule {rep.rule} x {x} {res}", file=out)

    if args.outfn:
        _save(cmap, args.outfn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
