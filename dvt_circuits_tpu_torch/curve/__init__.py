"""BLS12-381 on the card: ``fp`` (C1), ``g1`` (C2, C3) and ``g2`` (C4)."""
