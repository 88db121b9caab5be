"""Mean host time of the program's ``plan:<kernel>`` spans (the planner's
part of ``Context.launch``) in the window, in ms."""


def read(r):
    d = [s["dur"] for s in r.spans if s["name"].startswith("plan:")]
    return 1e3 * sum(d) / len(d) if d else None
