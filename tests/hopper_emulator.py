"""NumPy stand-ins for the Hopper kernels (hopper_fills.cu) with the same
arguments and outputs as hopper._call_linear / hopper._call_fanin.

CUDA has no interpret mode, so the CPU tests run the kernels' wrappers
(argument packing, padding, tiling, decode, routing) against these
per-diagonal transcriptions of the kernel loops; the kernels themselves
are compared with the scan cores on the card (tests marked `gpu`,
chip_smoke.py phase (a))."""
import contextlib

import numpy as np

NEG = np.float32(-np.inf)


@contextlib.contextmanager
def kernels_on_cpu():
    """Route CPU fills through the kernels' wrappers, with the NumPy
    transcriptions below in place of the CUDA calls."""
    from pagan2_tpu.align import backend, hopper
    saved = (backend._FILLS["cpu"], hopper._call_linear,
             hopper._call_fanin)
    backend._FILLS["cpu"] = dict(backend._FILLS["gpu"])
    hopper._call_linear = emulate_linear
    hopper._call_fanin = emulate_fanin
    try:
        yield
    finally:
        (backend._FILLS["cpu"], hopper._call_linear,
         hopper._call_fanin) = saved


def _best3(c0, c1, c2):
    """Strict-greater first-wins choice among three candidates."""
    v = c0.copy()
    code = np.zeros(v.shape, np.uint32)
    t = c1 > v
    v = np.where(t, c1, v)
    code = np.where(t, 1, code)
    t = c2 > v
    v = np.where(t, c2, v)
    code = np.where(t, 2, code)
    return v, code


def emulate_linear(rowf, rowi, colf, coli, tab, fsc, isc, ilo, W, T, nblk,
                   smem_state):
    rowf, rowi, colf, coli, tab, fsc, isc, ilo = (
        np.asarray(a) for a in (rowf, rowi, colf, coli, tab, fsc, isc,
                                ilo))
    B, D = ilo.shape
    nf = int(round(np.sqrt(tab.shape[1])))
    bp = np.full((B, D, W), 0x3F, np.uint8)
    fin = np.full((B, 3), NEG, np.float32)
    p = np.arange(W)
    for b in range(B):
        L, R = (int(v) for v in isc[b])
        lng, lgo = fsc[b]
        lw, gexti, olp = rowf[b]
        ls, blo, bhi = rowi[b]
        rw, gextj, orp = colf[b]
        rs = coli[b]
        tb = tab[b]
        # gen[k] = (M, X, Y) of diagonal d-k, index = position + 1
        gen = [[np.full(W + 2, NEG, np.float32) for _ in range(3)]
               for _ in range(3)]
        if ilo[b, 0] == 0:
            gen[1][0][1] = 0.0
        for d in range(1, min(L + R - 2, D - 1) + 1):
            il = int(ilo[b, d])
            dl1 = il - int(ilo[b, d - 1])
            dl2 = il - int(ilo[b, d - 2]) if d >= 2 else 0
            (M1, X1, Y1), (M2, X2, Y2) = gen[1], gen[2]
            i = il + p
            j = d - i
            valid = (i < L) & (j >= 0) & (j < R)
            ic = np.clip(i, 0, L - 1)
            jc = np.clip(j, 0, R - 1)
            valid &= (j >= blo[ic]) & (j <= bhi[ic])
            q = p + dl1
            vx, cx = _best3(X1[q] + gextj[jc], Y1[q] + lgo,
                            (M1[q] + lng) + olp[ic])
            okx = valid & (i > 0) & np.isfinite(vx)
            q = p + dl1 + 1
            vy, cy = _best3(Y1[q] + gexti[ic], X1[q] + lgo,
                            (M1[q] + lng) + orp[jc])
            oky = valid & (j > 0) & np.isfinite(vy)
            q = p + dl2
            wadd = ((lng + tb[ls[ic] * nf + rs[jc]]) + lw[ic]) + rw[jc]
            vm, cm = _best3((M2[q] + lng) + wadd, X2[q] + wadd,
                            Y2[q] + wadd)
            okm = valid & (i > 0) & (j > 0) & np.isfinite(vm)
            new = []
            for ok, v in ((okm, vm), (okx, vx), (oky, vy)):
                g = np.full(W + 2, NEG, np.float32)
                g[1:W + 1] = np.where(ok, v, NEG)
                new.append(g)
            bp[b, d] = (np.where(okm, cm, 3) | (np.where(okx, cx, 3) << 2)
                        | (np.where(oky, cy, 3) << 4)).astype(np.uint8)
            if d == L + R - 2 and 0 <= L - 1 - il < W:
                fin[b] = [g[L - il] for g in new]
            gen = [None, new, gen[1]]
    return bp, fin


def emulate_fanin(rowf, rowi, colf, coli, tab, fsc, isc, ilo, W, Gr, PAD,
                  smem_state):
    rowf, rowi, colf, coli, tab, fsc, isc, ilo = (
        np.asarray(a) for a in (rowf, rowi, colf, coli, tab, fsc, isc,
                                ilo))
    B, D = ilo.shape
    KL = rowi.shape[1] - 3
    KR = coli.shape[1] - 1
    nf = int(round(np.sqrt(tab.shape[1])))
    none = np.uint32(65535 + (255 << 16) + (255 << 24))
    bp = np.full((B, D, W), none, np.uint32)
    snap = np.full((B, 3, Gr, W), NEG, np.float32)
    pos_w = np.arange(W)
    for b in range(B):
        L, R = (int(v) for v in isc[b])
        lng, lgo = fsc[b]
        gexti = rowf[b, 0]
        llw = rowf[b, 1:1 + KL]
        lopen = rowf[b, 1 + KL:1 + 2 * KL]
        ls, blo, bhi = rowi[b, 0], rowi[b, 1], rowi[b, 2]
        loff = rowi[b, 3:]
        gextj = colf[b, 0]
        rlw = colf[b, 1:1 + KR]
        ropen = colf[b, 1 + KR:1 + 2 * KR]
        rs = coli[b, 0]
        roff = coli[b, 1:]
        tb = tab[b]
        # one position past the window stays -inf (reads beyond it)
        ring = np.full((Gr, 3, PAD + W + 1), NEG, np.float32)
        if ilo[b, 0] == 0:
            ring[0, 0, PAD] = 0.0

        def src(dd, m, row):
            """ring value of diagonal dd (>= 0 where used) at row `row`,
            -inf outside that diagonal's window."""
            q = np.minimum(row - ilo[b, dd], W)
            return ring[np.mod(dd, Gr), m, PAD + q]

        for d in range(1, min(L + R - 2, D - 1) + 1):
            i = ilo[b, d] + pos_w
            j = d - i
            valid = (i < L) & (j >= 0) & (j < R)
            ic = np.clip(i, 0, L - 1)
            jc = np.clip(j, 0, R - 1)
            valid &= (j >= blo[ic]) & (j <= bhi[ic])
            bestX = np.full(W, NEG, np.float32)
            codeX = np.full(W, 255, np.uint32)
            for e in range(KL):
                o = loff[e, ic]
                use = (o > 0) & (o <= d)
                pos = np.where(use, i - o, 0)
                dd = np.where(use, d - o, 0)
                for mv, cand in enumerate(
                        (src(dd, 1, pos) + gextj[jc],
                         src(dd, 2, pos) + lgo,
                         (src(dd, 0, pos) + lng) + lopen[e, ic])):
                    t = use & (cand > bestX)
                    bestX = np.where(t, cand, bestX)
                    codeX = np.where(t, 3 * e + mv, codeX)
            bestY = np.full(W, NEG, np.float32)
            codeY = np.full(W, 255, np.uint32)
            for e in range(KR):
                r = roff[e, jc]
                use = (r > 0) & (r <= d)
                dd = np.where(use, d - r, 0)
                for mv, cand in enumerate(
                        (src(dd, 2, i) + gexti[ic],
                         src(dd, 1, i) + lgo,
                         (src(dd, 0, i) + lng) + ropen[e, jc])):
                    t = use & (cand > bestY)
                    bestY = np.where(t, cand, bestY)
                    codeY = np.where(t, 3 * e + mv, codeY)
            bestM = np.full(W, NEG, np.float32)
            codeM = np.full(W, 65535, np.uint32)
            mbase = lng + tb[ls[ic] * nf + np.clip(rs[jc], 0, nf - 1)]
            for el in range(KL):
                s = loff[el, ic]
                lwb = mbase + llw[el, ic]
                for er in range(KR):
                    r = roff[er, jc]
                    use = (s > 0) & (r > 0) & (s + r <= d)
                    base = lwb + rlw[er, jc]
                    pos = np.where(use, i - s, 0)
                    dd = np.where(use, d - s - r, 0)
                    c0 = 3 * (el * KR + er)
                    for mv, cand in enumerate(
                            ((src(dd, 0, pos) + lng) + base,
                             src(dd, 1, pos) + base,
                             src(dd, 2, pos) + base)):
                        t = use & (cand > bestM)
                        bestM = np.where(t, cand, bestM)
                        codeM = np.where(t, c0 + mv, codeM)
            okx = valid & (i > 0) & np.isfinite(bestX)
            oky = valid & (j > 0) & np.isfinite(bestY)
            okm = valid & (i > 0) & (j > 0) & np.isfinite(bestM)
            slot = d % Gr
            ring[slot, 0, PAD:PAD + W] = np.where(okm, bestM, NEG)
            ring[slot, 1, PAD:PAD + W] = np.where(okx, bestX, NEG)
            ring[slot, 2, PAD:PAD + W] = np.where(oky, bestY, NEG)
            bp[b, d] = (np.where(okm, codeM, 65535)
                        + (np.where(okx, codeX, 255) << 16)
                        + (np.where(oky, codeY, 255) << 24)
                        ).astype(np.uint32)
            if d == L + R - 2:
                for g in range(Gr):
                    if d - g >= 0:
                        snap[b, :, g] = ring[(d - g) % Gr, :, PAD:PAD + W]
    return bp, snap
