"""The comparison that decides ``correct``.

The reference replays the run: every mutation batch the program
acknowledged, in the order it was served (a batch's deletes first, then
its upserts, the last upsert of an id winning: the mutation RPC's
contract), so that at each neighborhood RPC it knows which ids were live
and which feature row each held. It then judges what the program
returned and the state it left, with its own embedding, exact dots and
scorer (``references/<name>.py``); it reads the program's outputs only to
judge them.

Numbers, each with its limit (every one passes at or below it):

* ``failed`` requests that raised (0);
* ``stale_ids``: answered ids not live when the RPC ran, the query's own
  id, or an id twice in a row (0);
* ``short_rows``: index-served rows with fewer than ``min(k, live - 1)``
  ids (0);
* ``dist_mismatch``: share of answered (row, id) pairs whose distance is
  not minus the reference's exact dot of the two feature rows;
* ``weight_gap``: largest gap between an answered weight and the
  reference's pair score;
* ``recall_miss``: 1 - tie-aware recall@k of a sample of index-served
  RPCs against the reference's exact neighbours over the ids live then;
* ``index_live_diff``: ids live in the index but not by the replay, or
  the other way round (0);
* ``index_orphans``: valid partition entries of no live id's slot, plus
  live ids short of their copies (0);
* ``index_row_mismatch``: share of live ids whose stored row is not the
  reference's embedding of their latest features.

With ``control=True`` the reference in bfloat16 takes the program's place
for every distance, weight and stored row: the check has to fail it.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK = 1 << 16


class Judge:
    def __init__(self, ref, spec, buckets: dict, planes: dict, params: dict,
                 features: dict, boot_ids: np.ndarray, device,
                 control: bool = False):
        self.ref = ref
        self.spec = spec
        self.params = {k: v.detach().to(device) for k, v in params.items()}
        self.device = torch.device(device)
        self.features = {k: torch.as_tensor(v).to(self.device)
                         for k, v in features.items()}
        self.control = control
        self.emb = ref.embed(features, spec, buckets, planes, self.device)
        self.emb_c = (ref.embed(features, spec, buckets, planes, self.device,
                                "bf16") if control else None)
        self.emb_t = torch.as_tensor(self.emb).to(self.device)
        self.emb_c_t = (torch.as_tensor(self.emb_c).to(self.device)
                        if control else None)
        self.boot_ids = boot_ids

    # ---------------------------------------------------------- reference

    def _rows(self, v: np.ndarray) -> dict:
        at = torch.as_tensor(v).to(self.device)
        return {k: a[at] for k, a in self.features.items()}

    def scores(self, va: np.ndarray, vb: np.ndarray, precision="exact"):
        out = []
        for lo in range(0, va.size, BLOCK):
            out.append(self.ref.pair_score(
                self.params, self._rows(va[lo:lo + BLOCK]),
                self._rows(vb[lo:lo + BLOCK]), self.spec, precision).cpu())
        return (torch.cat(out).numpy() if out
                else np.zeros((0,), np.float64))

    def pair_dots(self, emb: torch.Tensor, va, vb) -> np.ndarray:
        """Exact dots of the rows ``va`` and ``vb`` of ``emb`` (on the
        device), pair by pair."""
        out = []
        for lo in range(0, va.size, BLOCK):
            a = emb[torch.as_tensor(va[lo:lo + BLOCK]).to(self.device)]
            b = emb[torch.as_tensor(vb[lo:lo + BLOCK]).to(self.device)]
            out.append(self.ref.pair_dots(a, b).cpu())
        return (torch.cat(out).numpy() if out
                else np.zeros((0,), np.int64))

    # ------------------------------------------------------------- replay

    def run(self, log: list, state: dict, recall_pick: set,
            limits: dict) -> list:
        """Checks [(name, value, limit)] of a run's ``log`` (every request
        served, set-up's included, in order) and final ``state``."""
        max_id = int(max(self.boot_ids.max(), max(
            (int(e["req"].batch.ids.max()) for e in log
             if e["kind"] == "mutate"), default=0), max(
            (int(e["req"].ids.max()) for e in log if e["kind"] == "query"),
            default=0))) + 1
        ver = np.full(max_id, -1, np.int64)
        ver[self.boot_ids] = self.boot_ids
        n_live = int(self.boot_ids.size)
        failed = stale = short = 0
        pa, pb, pw, pd = [], [], [], []
        recall_rows = []
        for i, e in enumerate(log):
            req = e["req"]
            if not e["ok"]:
                failed += 1
            if e["kind"] == "mutate":
                b = req.batch
                dele = b.kinds == 2
                was = ver[b.ids[dele]] >= 0
                ver[b.ids[dele]] = -1
                n_live -= int(was.sum())
                up = np.nonzero(~dele)[0]
                for j in up.tolist():
                    pid = int(b.ids[j])
                    n_live += int(ver[pid] < 0)
                    ver[pid] = req.version0 + j
                continue
            if not e["ok"]:
                continue
            ids, w, d = e["out"]
            qv = ver[req.ids]
            valid = ids >= 0
            cv = np.where(valid, ver[np.clip(ids, 0, max_id - 1)], -1)
            cv = np.where(ids >= max_id, -1, cv)
            own = ids == req.ids[:, None]
            # an id after its first place in the row
            order = np.argsort(ids, axis=1, kind="stable")
            srt = np.take_along_axis(ids, order, 1)
            dup = np.zeros_like(valid)
            np.put_along_axis(dup, order[:, 1:], srt[:, 1:] == srt[:, :-1], 1)
            dup &= valid
            stale += int((valid & ((cv < 0) | own | dup)).sum())
            want = min(req.k, n_live - 1)
            short += int((valid.sum(1) < want).sum())
            ok = valid & (cv >= 0) & ~own & (qv[:, None] >= 0)
            rr, cc = np.nonzero(ok)
            pa.append(qv[rr])
            pb.append(cv[rr, cc])
            pw.append(w[rr, cc])
            pd.append(d[rr, cc])
            if i in recall_pick:
                recall_rows.append((req, qv, ids, cv, ver.copy()))
        pa, pb = np.concatenate(pa), np.concatenate(pb)
        pw, pd = np.concatenate(pw), np.concatenate(pd)

        checks = [("failed", failed, 0), ("stale_ids", stale, 0),
                  ("short_rows", short, 0)]
        if self.control:
            pd = -self.pair_dots(self.emb_c_t, pa, pb).astype(np.float32)
            pw = self.scores(pa, pb, "bf16")
        if pa.size:
            want = -self.pair_dots(self.emb_t, pa, pb)
            checks.append(("dist_mismatch", float(np.mean(pd != want)),
                           limits["dist_mismatch"]))
            gap = float(np.max(np.abs(pw.astype(np.float64)
                                      - self.scores(pa, pb))))
            checks.append(("weight_gap", gap, limits["weight_gap"]))
        if recall_rows:
            checks.append(("recall_miss", 1.0 - self._recall(recall_rows),
                           limits["recall_miss"]))
        checks += self._index(state, ver, limits)
        return checks

    def _recall(self, rows: list) -> float:
        """Tie-aware recall@k: answered ids whose exact dot reaches the
        k-th best dot among the other live ids (and is above 0), over
        min(k, ids with a dot above 0)."""
        hit = tot = 0
        emb, dev = self.emb_t, self.device
        for req, qv, ids, cv, ver in rows:
            live = np.nonzero(ver >= 0)[0]
            db = emb[torch.as_tensor(ver[live]).to(dev)]
            live_t = torch.as_tensor(live).to(dev)
            for lo in range(0, qv.size, 16):
                q = emb[torch.as_tensor(qv[lo:lo + 16]).to(dev)]
                cnt = self.ref.dots(q, db)                       # [b, L]
                own = torch.as_tensor(req.ids[lo:lo + 16]).to(dev)
                cnt[live_t[None, :] == own[:, None]] = -1        # not itself
                kth = torch.topk(cnt, req.k, dim=1).values[:, -1].cpu().numpy()
                n_pos = (cnt > 0).sum(1).cpu().numpy()
                b_ids, b_cv = ids[lo:lo + 16], cv[lo:lo + 16]
                rr, cc = np.nonzero((b_ids >= 0) & (b_cv >= 0))
                got = self.pair_dots(emb, qv[lo:lo + 16][rr], b_cv[rr, cc])
                hit += int(((got >= kth[rr]) & (got > 0)).sum())
                tot += int(np.minimum(req.k, n_pos).sum())
        return hit / max(tot, 1)

    def _index(self, st: dict, ver: np.ndarray, limits: dict) -> list:
        live_ref = np.nonzero(ver >= 0)[0]
        ids, slots = st["index_ids"], st["index_slots"]
        diff = np.setxor1d(live_ref, ids).size
        both = np.isin(ids, live_ref)
        emb = self.emb_c if self.control else self.emb
        rows = st["index_rows"][both] if not self.control \
            else emb[ver[ids[both]]]
        want = self.emb[ver[ids[both]]]
        mism = float(np.mean(np.any(rows != want, axis=1))) if both.any() \
            else 0.0
        copies = 2 if st["soar"] else 1
        ent = st["index_entry_slots"]
        live_slot = np.zeros(st["index_slot_ids"].size, bool)
        live_slot[slots] = True
        orphans = int((~live_slot[ent]).sum())
        per = np.bincount(ent, minlength=live_slot.size)[slots]
        orphans += int(np.abs(per - copies).sum())
        return [("index_live_diff", diff, 0), ("index_orphans", orphans, 0),
                ("index_row_mismatch", mism, limits["index_row_mismatch"])]
