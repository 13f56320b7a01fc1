"""The plain reference of the device mapping step: the de Bruijn graph
built again from the transcripts (graph), each read's walk (walk), and the
answers and judge (answers).  NumPy only: it imports nothing of
pseudoaligner_torch, jax or pseudoaligner_tpu."""
