"""Sparse/dense multiply mode matrix (counterpart of
``examples/sparse_multiply.py``, examples/SparseMultiply.scala: args
``<A rows> <A cols> <B cols> <density> <mode>``, 6 mode combinations
:31-82):

mode 1: sparse × sparse, sparse result (CRM/outer-product analog)
mode 2: sparse × sparse via densify
mode 3: block sparse × block sparse (sparse × sparse contraction)
mode 4: dense × dense (baseline)
mode 5: dense × sparse
mode 6: sparse × dense (ELL/COO auto)
mode 7: sparse × dense through the BSR block-sparse kernel, whose backend
        the autotune ranking picks (``csrc/bsr_spmm.cu`` on the card)
"""

import sys

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 5:
        die("usage: sparse_multiply <A rows> <A cols> <B cols> <density> <mode 1-7>")
    rows, k, cols = (int(x) for x in argv[:3])
    density, mode = float(argv[3]), int(argv[4])

    import marlin_tpu_torch as mt
    from marlin_tpu_torch.ops.local import mult_dense_sparse

    mesh = mt.create_mesh()
    sa = mt.SparseVecMatrix.random(0, rows, k, density=density, mesh=mesh)
    sb = mt.SparseVecMatrix.random(1, k, cols, density=density, mesh=mesh)

    t0 = millis()
    if mode == 1:
        c = sa.multiply_sparse(sb)
        print(f"sparse×sparse (sparse result) {millis() - t0:.1f} millis, nnz {c.nnz}")
    elif mode == 2:
        c = sa.to_dense_vec_matrix().multiply(sb.to_dense_vec_matrix())
        mt.evaluate(c)
        print(f"sparse×sparse via densify {millis() - t0:.1f} millis")
    elif mode == 3:
        c = sa.multiply_sparse(sb)
        print(f"block sparse×sparse {millis() - t0:.1f} millis, nnz {c.nnz}")
    elif mode == 4:
        da = mt.BlockMatrix.random(0, rows, k, mesh=mesh)
        db = mt.BlockMatrix.random(1, k, cols, mesh=mesh)
        mt.evaluate(da, db)
        t0 = millis()
        mt.evaluate(da.multiply(db))
        print(f"dense×dense {millis() - t0:.1f} millis")
    elif mode == 5:
        da = mt.BlockMatrix.random(0, rows, k, mesh=mesh)
        mt.evaluate(da)
        t0 = millis()
        c = mt.BlockMatrix.from_array(mult_dense_sparse(da.logical(), sb.bcoo), mesh)
        mt.evaluate(c)
        print(f"dense×sparse {millis() - t0:.1f} millis")
    elif mode == 6:
        db = mt.BlockMatrix.random(1, k, cols, mesh=mesh)
        mt.evaluate(db)
        t0 = millis()
        c = sa.multiply(db)
        mt.evaluate(c)
        print(f"sparse×dense {millis() - t0:.1f} millis")
    elif mode == 7:
        db = mt.BlockMatrix.random(1, k, cols, mesh=mesh)
        mt.evaluate(db)
        t0 = millis()
        c = sa.multiply(db, format="bsr")
        mt.evaluate(c)
        bsr = sa.to_bsr()
        print(f"sparse×dense via BSR {millis() - t0:.1f} millis "
              f"(nnzb {bsr.nnzb}, block density {bsr.density:.3f})")
    else:
        die("mode must be 1-7")


if __name__ == "__main__":
    main()
