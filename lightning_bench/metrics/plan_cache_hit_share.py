"""Share of the window's plan-cache lookups that hit (the program's
``plan.cache{result=hit}`` counter over ``plan.cache``), in %."""


def read(r):
    total = r.counters.get("plan.cache", 0.0)
    hits = r.counters.get("plan.cache{result=hit}", 0.0)
    return 100.0 * hits / total if total else None
