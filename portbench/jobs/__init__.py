"""What one traffic mix does in a window, one module a job.

A job module has `Job(members, traffic, device)`, whose set-up makes what
its calls need, with `members_per_call` (how many members a call hands
the program), `warm()` (one call), `run()` (the timed call: one output a
member, None where the program refused one), `count(outs)` (counters the
metric readers read) and `judge(sample, rng)` (the compared numbers,
{name: (value, limit)}, for the outputs of the sampled calls, against the
plain reference)."""
