"""CRI containers the bank entry points open: @UTF tables, AFS2 (AWB)
banks and ACB cue databases (readers, and build_afs2)."""
