"""Graph ops: containers, MaxK, SpMM, fused MaxK SpGEMM."""
