"""knn_attn_roofline_pct.serve: the vector-attention modules' least time (K1 / K2
and their products, from shapes) over their device time (%)."""
from benchmark.readers import knn_roofline


def read(out, cell):
    return knn_roofline(out, cell)
