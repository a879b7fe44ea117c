"""Share of the round engine's (lane, client slot, local step) slots that
the schedules call for: lanes × selected clients × E summed over the
rounds, against lanes × cohort bucket × E bucket of the rounds' graph
shapes, in %.  The rest is padding that trains nothing."""


def read(run):
    live, provided = run.live_slots
    return 100.0 * live / provided if provided else None
