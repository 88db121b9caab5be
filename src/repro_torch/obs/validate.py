"""Chrome trace-event schema validator.

    PYTHONPATH=src python -m repro_torch.obs.validate trace.json [...]

Checks the subset of the Chrome trace-event format the runtime emits and
Perfetto requires: a ``traceEvents`` list whose events carry the required
keys with sane types, ``X`` events with non-negative ``dur``, and
non-decreasing ``ts`` across non-metadata events (the exporter sorts, so
any violation means a broken writer).
"""

from __future__ import annotations

import json
import sys

from .trace import CHROME_REQUIRED_KEYS


def validate_chrome_trace(obj) -> list[str]:
    """Return a list of human-readable schema violations (empty = valid)."""
    errors: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' list"]
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["'traceEvents' must be a non-empty list"]
    last_ts = None
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            errors.append(f"event {i}: not an object")
            continue
        for key in CHROME_REQUIRED_KEYS:
            if key not in e:
                errors.append(f"event {i}: missing required key {key!r}")
        if not isinstance(e.get("name"), str):
            errors.append(f"event {i}: 'name' must be a string")
        if not isinstance(e.get("ts"), (int, float)):
            errors.append(f"event {i}: 'ts' must be a number")
            continue
        if not isinstance(e.get("pid"), int) or not isinstance(
                e.get("tid"), int):
            errors.append(f"event {i}: 'pid'/'tid' must be integers")
        ph = e.get("ph")
        if ph == "X" and e.get("dur", -1.0) < 0:
            errors.append(f"event {i}: 'X' event needs dur >= 0")
        if ph != "M":  # metadata events are pinned at ts 0
            if last_ts is not None and e["ts"] < last_ts:
                errors.append(
                    f"event {i}: ts {e['ts']} < previous {last_ts} "
                    f"(timestamps must be non-decreasing)"
                )
            last_ts = e["ts"]
    return errors


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.validate trace.json [...]",
              file=sys.stderr)
        return 2
    failed = False
    for path in argv:
        try:
            with open(path) as f:
                obj = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            print(f"{path}: UNREADABLE ({exc})")
            failed = True
            continue
        errors = validate_chrome_trace(obj)
        if errors:
            failed = True
            print(f"{path}: INVALID")
            for err in errors[:20]:
                print(f"  - {err}")
        else:
            n = len(obj["traceEvents"])
            print(f"{path}: ok ({n} events)")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
