"""A plain float64 twin of ``gaussianhaircut_torch/csrc/precompute.cu``: the
forward and the hand-derived backward, formula by formula as the kernels
compute them, over columns of [P] values (``R[a][b]`` is row a, column b of
the rotation matrix, ``V[i][j]`` and ``M[i][k]`` the camera's row-vector
matrices).  The tests hold it against autograd of the port's composition
(``renderer.precompute_plain``) in float64, so that the kernels' derivation
is checked where no card is."""
import torch

from gaussianhaircut_torch.ops.sh import C0, C1, C2, C3


def sh_basis(deg, x, y, z):
    """The basis values of degree ``deg``, in ``ops/sh.py``'s order."""
    b = [torch.full_like(x, C0)]
    if deg > 0:
        b += [-C1 * y, C1 * z, -C1 * x]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        b += [C2[0] * xy, C2[1] * yz, C2[2] * (2 * zz - xx - yy), C2[3] * xz,
              C2[4] * (xx - yy)]
    if deg > 2:
        b += [C3[0] * y * (3 * xx - yy), C3[1] * xy * z, C3[2] * y * (4 * zz - xx - yy),
              C3[3] * z * (2 * zz - 3 * xx - 3 * yy), C3[4] * x * (4 * zz - xx - yy),
              C3[5] * z * (xx - yy), C3[6] * x * (xx - 3 * yy)]
    return b


def sh_basis_grad(deg, x, y, z, gb):
    """(d/dx, d/dy, d/dz) of sum_k gb[k] * basis_k, term by term."""
    gx, gy, gz = (torch.zeros_like(x) for _ in range(3))
    if deg > 0:
        gy = gy - C1 * gb[1]
        gz = gz + C1 * gb[2]
        gx = gx - C1 * gb[3]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        gx = gx + C2[0] * y * gb[4] - 2 * C2[2] * x * gb[6] + C2[3] * z * gb[7] \
            + 2 * C2[4] * x * gb[8]
        gy = gy + C2[0] * x * gb[4] + C2[1] * z * gb[5] - 2 * C2[2] * y * gb[6] \
            - 2 * C2[4] * y * gb[8]
        gz = gz + C2[1] * y * gb[5] + 4 * C2[2] * z * gb[6] + C2[3] * x * gb[7]
    if deg > 2:
        gx = gx + (C3[0] * 6 * xy * gb[9] + C3[1] * yz * gb[10] - C3[2] * 2 * xy * gb[11]
                   - C3[3] * 6 * xz * gb[12] + C3[4] * (4 * zz - 3 * xx - yy) * gb[13]
                   + C3[5] * 2 * xz * gb[14] + C3[6] * 3 * (xx - yy) * gb[15])
        gy = gy + (C3[0] * 3 * (xx - yy) * gb[9] + C3[1] * xz * gb[10]
                   + C3[2] * (4 * zz - xx - 3 * yy) * gb[11] - C3[3] * 6 * yz * gb[12]
                   - C3[4] * 2 * xy * gb[13] - C3[5] * 2 * yz * gb[14]
                   - C3[6] * 6 * xy * gb[15])
        gz = gz + (C3[1] * xy * gb[10] + C3[2] * 8 * yz * gb[11]
                   + C3[3] * (6 * zz - 3 * xx - 3 * yy) * gb[12] + C3[4] * 8 * xz * gb[13]
                   + C3[5] * (xx - yy) * gb[14])
    return gx, gy, gz


def twin(f: dict, cam: dict, deg: int, mod: float, width: int, height: int, g: dict):
    """Forward and backward of the precompute.  ``f``: xyz [P, 3], features
    [P, K, 3], scaling [P, 3], rotation_matrix [P, 3, 3], label, orient_conf
    [P, 1], viewspace [P, 3], use_direction [P] or None; ``cam``: viewmatrix,
    projmatrix [4, 4], campos [3], tan_fovx, tan_fovy; ``g``: the gradients
    of ndc, conic [P, 3], colors [P, 10] and depth [P].  Returns (outputs,
    input gradients, camera gradients) as dicts of tensors shaped like the
    composition's."""
    P, K = f["features"].shape[:2]
    nk = (deg + 1) ** 2
    x = [f["xyz"][:, i] for i in range(3)]
    R = [[f["rotation_matrix"][:, a, b] for b in range(3)] for a in range(3)]
    sh = [[f["features"][:, k, c] for c in range(3)] for k in range(nk)]
    s = [f["scaling"][:, a] * mod for a in range(3)]
    V = [[cam["viewmatrix"][i, j] for j in range(4)] for i in range(4)]
    M = [[cam["projmatrix"][i, k] for k in range(4)] for i in range(4)]
    campos, tanx, tany = cam["campos"], cam["tan_fovx"], cam["tan_fovy"]
    u = (torch.ones(P, dtype=x[0].dtype) if f["use_direction"] is None
         else f["use_direction"])

    # ---- forward
    t = [x[0] * V[0][j] + x[1] * V[1][j] + x[2] * V[2][j] + V[3][j] for j in range(3)]
    tx, ty, tz = t
    recx, recy = 1.0 / (2.0 * tanx), 1.0 / (2.0 * tany)
    fx, fy = recx * width, recy * height
    limx, limy = 1.3 * tanx, 1.3 * tany
    ux, uy = tx / tz, ty / tz
    cx, cy = torch.clamp(ux, -limx, limx), torch.clamp(uy, -limy, limy)
    txc, tyc = cx * tz, cy * tz
    J00, J11 = fx / tz, fy / tz
    J20, J21 = -(fx * txc) / (tz * tz), -(fy * tyc) / (tz * tz)
    T = [[V[i][0] * J00 + V[i][2] * J20, V[i][1] * J11 + V[i][2] * J21] for i in range(3)]
    m = [[s[a] * R[a][b] for b in range(3)] for a in range(3)]
    Sig = [[sum(m[a][b] * m[a][c] for a in range(3)) for c in range(3)] for b in range(3)]
    A = [[sum(T[i][a] * Sig[i][j] for i in range(3)) for j in range(3)] for a in range(2)]
    cA = sum(A[0][j] * T[j][0] for j in range(3)) + 0.3
    cB = sum(A[0][j] * T[j][1] for j in range(3))
    cC = sum(A[1][j] * T[j][1] for j in range(3)) + 0.3
    det = cA * cC - cB * cB
    det_inv = 1.0 / (det + 1e-12)
    p = [x[0] * M[0][k] + x[1] * M[1][k] + x[2] * M[2][k] + M[3][k] for k in range(4)]
    pw = 1.0 / (p[3] + 1e-7)
    d = [x[i] - campos[i] for i in range(3)]
    n2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    r = torch.sqrt(torch.clamp(n2, min=1e-24))
    dr = [d[i] / r for i in range(3)]
    b = sh_basis(deg, *dr)
    raw = [sum(b[k] * sh[k][c] for k in range(nk)) + 0.5 for c in range(3)]
    rgb = [torch.where(raw[c] < 0, torch.zeros_like(raw[c]), raw[c]) for c in range(3)]
    # the first largest scale, NaN counting as largest (torch.argmax's rule)
    jmax = torch.zeros(P, dtype=torch.long)
    for a in (1, 2):
        cur = torch.stack(s, -1).gather(-1, jmax[:, None])[:, 0]
        jmax = torch.where((s[a] > cur) | (torch.isnan(s[a]) & ~torch.isnan(cur)),
                           torch.full_like(jmax, a), jmax)
    sel = lambda rows: torch.stack(rows, -1).gather(-1, jmax[:, None])[:, 0]
    sj = sel(s)
    Rj = [sel([R[a][i] for a in range(3)]) for i in range(3)]
    dv = [Rj[i] * sj for i in range(3)]
    dir2 = [sum(dv[i] * T[i][c] for i in range(3)) for c in range(2)]
    zero = dv[0] * 0 + dv[1] * 0 + dv[2] * 0
    oc, label = f["orient_conf"][:, 0], f["label"][:, 0]
    colors = torch.stack(rgb + [label, torch.ones_like(label), dir2[0] * u, dir2[1] * u,
                                zero * u, oc * u, tz], -1)
    out = {"ndc": torch.stack([p[k] * pw for k in range(3)], -1) + f["viewspace"],
           "conic": torch.stack([cC * det_inv, -cB * det_inv, cA * det_inv], -1),
           "colors": colors, "depth": tz}

    # ---- backward
    gn, gq, gc, gd = g["ndc"], g["conic"], g["colors"], g["depth"]
    gx = [torch.zeros(P, dtype=tz.dtype) for _ in range(3)]
    gR = [[torch.zeros(P, dtype=tz.dtype) for _ in range(3)] for _ in range(3)]
    gs = [torch.zeros(P, dtype=tz.dtype) for _ in range(3)]
    # colours: the SH, through the unit direction into xyz and campos
    graw = [torch.where(raw[c] >= 0, gc[:, c], torch.zeros_like(raw[c])) for c in range(3)]
    gsh = torch.zeros_like(f["features"])
    for k in range(nk):
        for c in range(3):
            gsh[:, k, c] = b[k] * graw[c]
    gb = [sum(sh[k][c] * graw[c] for c in range(3)) for k in range(nk)]
    gdr = sh_basis_grad(deg, *dr, gb)
    gr = -(gdr[0] * d[0] + gdr[1] * d[1] + gdr[2] * d[2]) / (r * r)
    gn2 = torch.where(n2 >= 1e-24, gr * 0.5 / r, torch.zeros_like(r))
    gdd = [gdr[i] / r + 2 * d[i] * gn2 for i in range(3)]
    for i in range(3):
        gx[i] = gx[i] + gdd[i]
    # the NDC
    gp = [gn[:, k] * pw for k in range(3)]
    gpw = gn[:, 0] * p[0] + gn[:, 1] * p[1] + gn[:, 2] * p[2]
    gp.append(-gpw * pw * pw)
    for i in range(3):
        gx[i] = gx[i] + sum(M[i][k] * gp[k] for k in range(4))
    # the conic, into the 2-D covariance, T and the 3-D covariance
    gdi = gq[:, 0] * cC - gq[:, 1] * cB + gq[:, 2] * cA
    gdet = -gdi * det_inv * det_inv
    G00 = gq[:, 2] * det_inv + gdet * cC
    G01 = -gq[:, 1] * det_inv - 2 * cB * gdet
    G11 = gq[:, 0] * det_inv + gdet * cA
    gA = [[G00 * T[j][0] + G01 * T[j][1] for j in range(3)], [G11 * T[j][1] for j in range(3)]]
    gT = [[A[0][j] * G00 + sum(Sig[j][k] * gA[0][k] for k in range(3)),
           A[0][j] * G01 + A[1][j] * G11 + sum(Sig[j][k] * gA[1][k] for k in range(3))]
          for j in range(3)]
    gSig = [[T[i][0] * gA[0][j] + T[i][1] * gA[1][j] for j in range(3)] for i in range(3)]
    for a in range(3):
        for k in range(3):
            gm = sum(m[a][c] * (gSig[k][c] + gSig[c][k]) for c in range(3))
            gs[a] = gs[a] + gm * R[a][k]
            gR[a][k] = gR[a][k] + gm * s[a]
    # the 2-D direction, through T and the principal axis
    gdir = [gc[:, 5] * u, gc[:, 6] * u]
    gdv = [T[i][0] * gdir[0] + T[i][1] * gdir[1] for i in range(3)]
    for i in range(3):
        for c in range(2):
            gT[i][c] = gT[i][c] + dv[i] * gdir[c]
    gsj = gdv[0] * Rj[0] + gdv[1] * Rj[1] + gdv[2] * Rj[2]
    for a in range(3):
        hit = jmax == a
        gs[a] = gs[a] + torch.where(hit, gsj, torch.zeros_like(gsj))
        for i in range(3):
            gR[a][i] = gR[a][i] + torch.where(hit, gdv[i] * sj, torch.zeros_like(gsj))
    # T = W J, into J and the view matrix
    gJ00 = sum(V[i][0] * gT[i][0] for i in range(3))
    gJ20 = sum(V[i][2] * gT[i][0] for i in range(3))
    gJ11 = sum(V[i][1] * gT[i][1] for i in range(3))
    gJ21 = sum(V[i][2] * gT[i][1] for i in range(3))
    gV = [[torch.zeros(P, dtype=tz.dtype) for _ in range(3)] for _ in range(4)]
    for i in range(3):
        gV[i][0] = gV[i][0] + gT[i][0] * J00
        gV[i][1] = gV[i][1] + gT[i][1] * J11
        gV[i][2] = gV[i][2] + gT[i][0] * J20 + gT[i][1] * J21

    def jac_axis(gJd, gJn, f_, t_c, c_, u_, t_, lim):
        """J_d = f / tz and J_n = -(f t_c) / tz^2 with t_c = clamp(u, -lim,
        lim) tz, u = t / tz -> (g_f, g_t, g_tz, g_lim)."""
        g_f = gJd / tz
        g_tz = -gJd * f_ / (tz * tz)
        q, den = f_ * t_c, tz * tz
        g_q = -gJn / den
        g_tz = g_tz + 2 * tz * (gJn * q / (den * den))
        g_f = g_f + g_q * t_c
        g_tc = g_q * f_
        g_c = g_tc * tz
        g_tz = g_tz + g_tc * c_
        inside = (u_ >= -lim) & (u_ <= lim)
        g_u = torch.where(inside, g_c, torch.zeros_like(g_c))
        g_lim = torch.where(u_ > lim, g_c, torch.zeros_like(g_c)) \
            - torch.where(u_ < -lim, g_c, torch.zeros_like(g_c))
        return g_f, g_u / tz, g_tz - g_u * t_ / (tz * tz), g_lim

    gfx, gtx, gtz_x, glimx = jac_axis(gJ00, gJ20, fx, txc, cx, ux, tx, limx)
    gfy, gty, gtz_y, glimy = jac_axis(gJ11, gJ21, fy, tyc, cy, uy, ty, limy)
    gt = [gtx, gty, gtz_x + gtz_y + gc[:, 9] + gd]
    for i in range(3):
        gx[i] = gx[i] + sum(V[i][j] * gt[j] for j in range(3))
        for j in range(3):
            gV[i][j] = gV[i][j] + x[i] * gt[j]
    for j in range(3):
        gV[3][j] = gV[3][j] + gt[j]
    gtanx = -(gfx * width) * recx * recx * 2 + 1.3 * glimx
    gtany = -(gfy * height) * recy * recy * 2 + 1.3 * glimy

    grads = {"xyz": torch.stack(gx, -1), "features": gsh,
             "scaling": torch.stack(gs, -1) * mod,
             "rotation_matrix": torch.stack([torch.stack(row, -1) for row in gR], 1),
             "label": gc[:, 3:4], "orient_conf": (gc[:, 8] * u)[:, None],
             "viewspace": gn}
    gview = torch.zeros(4, 4, dtype=tz.dtype)
    for i in range(4):
        for j in range(3):
            gview[i, j] = gV[i][j].sum()
    gproj = torch.stack([torch.stack([(x[i] * gp[k]).sum() if i < 3 else gp[k].sum()
                                      for k in range(4)]) for i in range(4)])
    gcam = {"viewmatrix": gview, "projmatrix": gproj,
            "campos": torch.stack([-gdd[i].sum() for i in range(3)]),
            "tan_fovx": gtanx.sum(), "tan_fovy": gtany.sum()}
    return out, grads, gcam
