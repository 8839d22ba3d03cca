"""Host-clock seconds of building or loading the operator's plan in set-up
(plan.FactoredNPBPlan), synchronised."""


def read(r):
    return r.spans.get("plan_build")
