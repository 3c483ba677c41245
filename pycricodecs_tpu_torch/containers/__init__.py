"""CRI containers the bank entry points open and the builders write:
@UTF tables, AFS2 (AWB) banks and ACB cue databases (readers, build_afs2,
UTFBuilder, AWBBuilder, ACBBuilder)."""
