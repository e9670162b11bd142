"""The sweep front end's building and packing of the programs a pass:
the program's ``sweep.build`` spans in the window over the passes
(program spans, host clock)."""


def read(facts):
    if "sweep_build_s" not in facts or not facts.get("passes"):
        return None
    return facts["sweep_build_s"] / facts["passes"] * 1e3
