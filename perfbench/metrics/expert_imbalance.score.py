"""How unevenly the router loads the held experts: the busiest held
expert's (token, slot) pairs over the mean held expert's, from the
program's counters ``moe.pairs_busiest`` and ``moe.pairs_held`` summed
over the layers of an evaluation; 1 where every held expert gets as many
pairs. The grouped products wait on the busiest expert's rows, so this
says how far ``expert_gemm_roofline.score`` is held down by the routing
and not by the products."""
from perfbench import program_counters


def read(run):
    busiest = program_counters.per_unit(run, "moe.pairs_busiest", "score")
    pairs = program_counters.per_unit(run, "moe.pairs_held", "score")
    if not busiest or not pairs:
        return None
    m = run.model
    return busiest * (m.get("experts_held") or m["n_experts"]) / pairs
