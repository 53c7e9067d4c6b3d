"""Graph ops: containers, MaxK, SpMM, CBSR, fused MaxK SpGEMM."""
