"""The share of a launch's cell time that does work: every cell's events
over the cells times the longest cell's events, summed over the window's
``sweep.run`` calls (the program's ``pad_stats`` counters).  A block whose
cell finished early waits for the launch's longest."""


def read(facts):
    if not facts.get("sweep_cell_slots"):
        return None
    return 100.0 * facts["sweep_events"] / facts["sweep_cell_slots"]
