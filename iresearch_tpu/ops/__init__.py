"""Device operators shared by the executors: the fused dense-grid scan
(ops/dense_scan.py) and top-k over wide rows (ops/topk.py)."""
