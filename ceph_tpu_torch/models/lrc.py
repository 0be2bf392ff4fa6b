"""LRC plugin: locally-repairable layered code.

Counterpart of ``ceph_tpu/models/lrc.py``.  The codec's device reaches
every layer's inner codec, which the port's registry builds.  Encode
and decode take numpy chunks or uint8 tensors on the codec's device; a
tensor stays on the device through every layer, and the result comes
back in the kind the caller gave.

Behavior mirror of reference:src/erasure-code/lrc/ErasureCodeLrc.{h,cc}:

- profile is either a JSON ``layers`` list + ``mapping`` string
  (layers_parse, :131) or the ``k/m/l`` shorthand expanded to a global
  layer + per-group local layers (parse_kml, :281 — same expansion
  strings);
- each Layer has a chunks_map over the full chunk space (D=data in layer,
  c=coding in layer, _=not in layer) and an inner codec (default jerasure
  reed_sol_van) with the layer's own k/m (:76-95);
- encode runs layers in order on their chunk subsets (:727), so local
  layers protect global parities too;
- decode iterates layers repeatedly, reusing chunks recovered by previous
  layers until the wanted erasures are gone (:765);
- minimum_to_decode walks layers in reverse, preferring a single local
  -layer read set (:555).

Crush ruleset-steps from the profile are parsed and stored for the
placement layer (create_ruleset analog lives with CRUSH, not here).
"""

from __future__ import annotations

import json
from typing import Mapping, Sequence

import numpy as np
import torch

from .base import ErasureCode, device_bytes
from .interface import ErasureCodeValidationError
from .registry import ErasureCodePlugin, PLUGIN_VERSION, instance

__erasure_code_version__ = PLUGIN_VERSION

DEFAULT_INNER = {"plugin": "jerasure", "technique": "reed_sol_van"}


def _inner_engine(inner, op: str, host: bool):
    """Pick an inner codec's device or host engine for ``op``
    (osd/ec_failover): on the host route, an inner without a
    ``<op>_host`` oracle falls back to its device method — every
    in-repo plugin ships one, so this only triggers for third-party
    inners."""
    if host:
        return getattr(inner, f"{op}_host", getattr(inner, op))
    return getattr(inner, op)


def _host_bytes(c) -> np.ndarray:
    """A chunk as host uint8 memory (the host engines read numpy)."""
    if isinstance(c, torch.Tensor):
        c = c.cpu().numpy()
    return np.asarray(c, dtype=np.uint8)


class Layer:
    def __init__(self, chunks_map: str, profile: Mapping[str, str], device):
        self.chunks_map = chunks_map
        self.data = [i for i, ch in enumerate(chunks_map) if ch == "D"]
        self.coding = [i for i, ch in enumerate(chunks_map) if ch == "c"]
        self.chunks = self.data + self.coding
        self.chunks_as_set = set(self.chunks)
        prof = dict(DEFAULT_INNER)
        prof.update(profile)
        prof["k"] = str(len(self.data))
        prof["m"] = str(len(self.coding))
        plugin = prof.pop("plugin")
        self.erasure_code = instance().factory(plugin, prof, device=device)


def _parse_layer_profile(spec) -> dict:
    """Second element of a layer entry: '' | 'k=v k=v' | JSON object."""
    if spec is None or spec == "":
        return {}
    if isinstance(spec, dict):
        return {str(k): str(v) for k, v in spec.items()}
    out = {}
    for tok in str(spec).split():
        if "=" not in tok:
            raise ErasureCodeValidationError(
                f"layer profile token {tok!r} is not k=v"
            )
        key, val = tok.split("=", 1)
        out[key] = val
    return out


class LrcErasureCode(ErasureCode):
    def __init__(self, device=None):
        super().__init__(device)
        self.layers: list[Layer] = []
        self.mapping = ""  # global D/_ string
        self.ruleset_steps: list[tuple[str, str, int]] = []

    # -- profile ------------------------------------------------------------

    def init(self, profile: Mapping[str, str]) -> None:
        profile = dict(profile)
        if "k" in profile or "m" in profile or "l" in profile:
            self._parse_kml(profile)
        if "layers" not in profile:
            raise ErasureCodeValidationError(
                "LRC profile needs either layers+mapping or k/m/l"
            )
        if "mapping" not in profile:
            raise ErasureCodeValidationError("LRC profile needs a mapping string")
        self.mapping = profile["mapping"]
        try:
            descr = json.loads(profile["layers"])
        except json.JSONDecodeError as e:
            raise ErasureCodeValidationError(
                f"layers is not valid JSON: {e}"
            ) from e
        if not isinstance(descr, list) or not descr:
            raise ErasureCodeValidationError("layers must be a non-empty list")
        self.layers = []
        for entry in descr:
            if not isinstance(entry, list) or not entry:
                raise ErasureCodeValidationError(
                    f"layer entry {entry!r} must be [chunks_map, profile]"
                )
            cmap = entry[0]
            prof = _parse_layer_profile(entry[1] if len(entry) > 1 else "")
            if len(cmap) != len(self.mapping):
                raise ErasureCodeValidationError(
                    f"layer map {cmap!r} length != mapping {self.mapping!r} length"
                )
            self.layers.append(Layer(cmap, prof, self.device))
        self.k = sum(1 for ch in self.mapping if ch == "D")
        self.m = len(self.mapping) - self.k
        self.chunk_mapping = [i for i, ch in enumerate(self.mapping) if ch == "D"]
        # every non-data position must be coding in exactly one layer
        covered: set[int] = set()
        for layer in self.layers:
            dup = covered & set(layer.coding)
            if dup:
                raise ErasureCodeValidationError(
                    f"chunk positions {sorted(dup)} are coding in multiple layers"
                )
            covered |= set(layer.coding)
        missing = set(range(len(self.mapping))) - set(self.chunk_mapping) - covered
        if missing:
            raise ErasureCodeValidationError(
                f"chunk positions {sorted(missing)} are neither data nor coding"
            )
        if "ruleset-steps" in profile:
            # explicit steps for the layers form (reference ruleset_parse,
            # reference:src/erasure-code/lrc/ErasureCodeLrc.cc:88)
            try:
                raw = json.loads(profile["ruleset-steps"])
                steps = [(str(op), str(t), int(n)) for op, t, n in raw]
            except (json.JSONDecodeError, TypeError, ValueError) as e:
                raise ErasureCodeValidationError(
                    f"bad ruleset-steps: {e}"
                ) from e
            for op, _t, _n in steps:
                if op not in ("choose", "chooseleaf"):
                    raise ErasureCodeValidationError(
                        f"ruleset-steps op must be choose|chooseleaf, got {op!r}"
                    )
            self.ruleset_steps = steps
        elif not self.ruleset_steps:
            self.ruleset_steps = [
                ("chooseleaf", profile.get("ruleset-failure-domain", "host"), 0)
            ]
        self._profile = dict(profile)

    def get_ruleset_steps(self):
        """Per-layer placement steps consumed at pool creation
        (reference:src/erasure-code/lrc/ErasureCodeLrc.cc:44
        create_ruleset)."""
        return list(self.ruleset_steps)

    def _parse_kml(self, profile: dict) -> None:
        for banned in ("mapping", "layers"):
            if banned in profile:
                raise ErasureCodeValidationError(
                    f"the {banned} parameter cannot be set when k/m/l are set"
                )
        k = self.to_int("k", profile, -1)
        m = self.to_int("m", profile, -1)
        l = self.to_int("l", profile, -1)
        if -1 in (k, m, l):
            raise ErasureCodeValidationError("all of k, m, l must be set")
        if (k + m) % l:
            raise ErasureCodeValidationError("k + m must be a multiple of l")
        groups = (k + m) // l
        if k % groups or m % groups:
            raise ErasureCodeValidationError(
                "k and m must be multiples of (k + m) / l"
            )
        kg, mg = k // groups, m // groups
        profile["mapping"] = ("D" * kg + "_" * mg + "_") * groups
        layers = [["".join(("D" * kg + "c" * mg + "_") * groups), ""]]
        for i in range(groups):
            row = "".join(
                ("D" * l + "c") if i == j else ("_" * (l + 1))
                for j in range(groups)
            )
            layers.append([row, ""])
        profile["layers"] = json.dumps(layers)
        locality = profile.get("ruleset-locality", "")
        failure_domain = profile.get("ruleset-failure-domain", "host")
        if locality:
            self.ruleset_steps = [
                ("choose", locality, groups),
                ("chooseleaf", failure_domain, l + 1),
            ]
        else:
            self.ruleset_steps = [("chooseleaf", failure_domain, 0)]

    # -- geometry -----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return len(self.mapping)

    def get_alignment(self) -> int:
        return max(
            [128] + [layer.erasure_code.get_alignment() for layer in self.layers]
        )

    def batch_alignment(self) -> int:
        import math

        out = 1
        for layer in self.layers:
            out = math.lcm(out, layer.erasure_code.batch_alignment())
        return out

    # -- encode -------------------------------------------------------------

    def encode(
        self, want_to_encode: Sequence[int], data: bytes | np.ndarray
    ) -> dict[int, np.ndarray]:
        chunks = self.encode_prepare(data)  # [k, C]
        n = self.get_chunk_count()
        C = chunks.shape[1]
        full = np.zeros((n, C), dtype=np.uint8)
        full[self.chunk_mapping] = chunks
        for layer in self.layers:
            parity = layer.erasure_code.encode_chunks(full[layer.data])
            full[layer.coding] = parity
        return {i: full[i] for i in want_to_encode}

    def encode_chunks(self, data_chunks: np.ndarray) -> np.ndarray:
        return self._encode_chunks_impl(data_chunks, host=False)

    def encode_chunks_host(self, data_chunks: np.ndarray) -> np.ndarray:
        """Host-engine parity (osd/ec_failover): the same layered pass
        routed through each inner codec's host oracle, so an LRC
        failover replay never re-enters the device it is failing away
        from."""
        return self._encode_chunks_impl(data_chunks, host=True)

    def _encode_chunks_impl(
        self, data_chunks: np.ndarray, *, host: bool
    ) -> np.ndarray:
        n = self.get_chunk_count()
        C = data_chunks.shape[1]
        if isinstance(data_chunks, torch.Tensor) and not host:
            # device-resident: every layer's chunks stay on the device
            full = data_chunks.new_zeros((n, C))
            full[self.chunk_mapping] = data_chunks
        else:
            full = np.zeros((n, C), dtype=np.uint8)
            full[self.chunk_mapping] = np.asarray(data_chunks, dtype=np.uint8)
        for layer in self.layers:
            enc = _inner_engine(layer.erasure_code, "encode_chunks", host)
            full[layer.coding] = enc(full[layer.data])
        data_positions = set(self.chunk_mapping)
        coding_positions = [i for i in range(n) if i not in data_positions]
        return full[coding_positions]

    # -- decode -------------------------------------------------------------

    def minimum_to_decode(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ) -> list[int]:
        want = set(want_to_read)
        avail = set(available)
        erasures_not_recovered = set(range(self.get_chunk_count())) - avail
        erasures_want = want & erasures_not_recovered
        if not erasures_want:
            return sorted(want)
        # iterate layers to a fixed point, exactly like decode() (reference
        # :765): a layer may only become decodable after another layer
        # recovered one of its chunks (e.g. global recovers a data chunk,
        # then the local layer rebuilds its parity).  Locals come first
        # (reversed), so a single-local-group read wins when possible.
        minimum: set[int] = set()
        progress = True
        while erasures_want and progress:
            progress = False
            for layer in reversed(self.layers):
                erasures = layer.chunks_as_set & erasures_not_recovered
                if not erasures:
                    continue
                if len(erasures) > layer.erasure_code.get_coding_chunk_count():
                    continue  # too many for this layer this round
                minimum |= layer.chunks_as_set - erasures_not_recovered
                erasures_not_recovered -= erasures
                erasures_want -= erasures
                progress = True
                if not erasures_want:
                    break
        if erasures_want:
            raise IOError(
                f"cannot decode chunks {sorted(erasures_want)} from {sorted(avail)}"
            )
        minimum |= want & avail
        # recovered-in-flight chunks are reconstructed, not read
        minimum -= set(range(self.get_chunk_count())) - avail
        return sorted(minimum)

    def decode(
        self, want_to_read: Sequence[int], chunks: Mapping[int, np.ndarray],
        *, _host: bool = False,
    ) -> dict[int, np.ndarray]:
        want = list(want_to_read)
        # device-resident when any chunk is a tensor: every layer then
        # decodes on the device and hands its tensors to the next
        on_device = not _host and any(
            isinstance(c, torch.Tensor) for c in chunks.values()
        )
        if on_device:
            have = {i: device_bytes(c, self.device)[0] for i, c in chunks.items()}
            stack = torch.stack
        else:
            have = {i: _host_bytes(c) for i, c in chunks.items()}
            stack = np.stack
        missing_want = [i for i in want if i not in have]
        if not missing_want:
            return {i: have[i] for i in want}
        # iterate layers until no progress (reference :765)
        progress = True
        while progress and any(i not in have for i in want):
            progress = False
            for layer in reversed(self.layers):
                layer_missing = [i for i in layer.chunks if i not in have]
                if not layer_missing:
                    continue
                inner = layer.erasure_code
                if len(layer_missing) > inner.get_coding_chunk_count():
                    continue
                present_local = [
                    pos for pos, gi in enumerate(layer.chunks) if gi in have
                ]
                missing_local = [
                    pos for pos, gi in enumerate(layer.chunks) if gi not in have
                ]
                if len(present_local) < inner.get_data_chunk_count():
                    continue
                try:
                    stacked = stack([have[layer.chunks[p]] for p in present_local])
                    rebuilt = _inner_engine(inner, "decode_chunks", _host)(
                        present_local, stacked, missing_local
                    )
                except (IOError, ValueError):
                    continue
                for j, pos in enumerate(missing_local):
                    have[layer.chunks[pos]] = rebuilt[j]
                progress = True
        still = [i for i in want if i not in have]
        if still:
            raise IOError(f"cannot decode chunks {still}")
        return {i: have[i] for i in want}

    def decode_chunks(self, present: Sequence[int], chunks, missing: Sequence[int]):
        got = self.decode(
            list(missing),
            {r: chunks[i] for i, r in enumerate(present)},
        )
        stack = torch.stack if isinstance(chunks, torch.Tensor) else np.stack
        return stack([got[r] for r in missing])

    def decode_chunks_host(
        self, present: Sequence[int], chunks: np.ndarray, missing: Sequence[int]
    ) -> np.ndarray:
        """Host-engine reconstruct (osd/ec_failover): the same layered
        fixed-point, each layer solved on its inner host oracle."""
        got = self.decode(
            list(missing),
            {r: chunks[i] for i, r in enumerate(present)},
            _host=True,
        )
        return np.stack([got[r] for r in missing])

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> bytes:
        decoded = self.decode(self.chunk_mapping, chunks)
        return b"".join(bytes(decoded[i]) for i in self.chunk_mapping)


class ErasureCodePluginLrc(ErasureCodePlugin):
    def factory(self, profile: Mapping[str, str], device):
        codec = LrcErasureCode(device)
        codec.init(profile)
        return codec


def __erasure_code_init__(name: str, registry) -> None:
    registry.add(name, ErasureCodePluginLrc())
