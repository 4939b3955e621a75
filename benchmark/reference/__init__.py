"""The benchmark's plain reference: LPFormer's graph derivation, context
extraction, forward, loss, clipped Adam and citation2 evaluation in plain
PyTorch, and the personalized-PageRank push in NumPy.

It imports torch and numpy only: nothing of the program under test and
nothing of JAX. It works out from the raw edges and features everything the
program derives from them (the adjacency, its GCN normalisation, the capped
rows, the batch masking, the context sets, the propagation). An evaluation
check pushes the PPR rows of every link it scores itself; a training check
takes the program's PPR matrix, of which it pushes a sample of rows, the
highest-degree nodes among them, to compare (PERF.md, section 4).
"""
