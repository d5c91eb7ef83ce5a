"""The comparison that decides ``correct``: the program's outputs judged by
the plain reference (``benchmark/reference``), number by number.

With random weights the logits that the top-k cuts and NMS compare are
near ties, so which candidates a selection keeps flips with the last bits
of precision, and the kept sets are not compared as sets.  The values are
compared where the reference follows the program's picks, and what a
selection must guarantee whatever the precision is checked: no two kept
boxes of one NMS problem overlap by more than its IoU threshold (plus 1e-3
for the rounding of the box coordinates), and nothing is left out that
the selection had to keep.  Greedy NMS under a top-k drops a candidate
only for a kept box of its problem that overlaps it and outscores it, or
for the cut; so a candidate that no kept box matches may outscore, in the
reference, neither the cut nor every kept box that overlaps it by more
than the threshold.  The amount by which one does (its order flip) is
what near ties allow; a dropped, suppressed-for-nothing or garbage output
reads the height of the best candidate above the cut.

Inference (``judge_predict``), per checked batch:

- the RPN: ``rpn_logit_gap``, the mean gap between a proposal's objectness
  logit and the reference's for the same candidate (the reference's
  candidate before NMS with that box, IoU >= 0.95, and of those the
  nearest logit),
  ``rpn_nms_violations``, the pairs of proposals of one level (the level
  of their candidates) that overlap by more than the RPN's NMS threshold,
  and ``rpn_missed_gap``, the widest order flip (in logits) of a
  reference candidate the proposals leave out, against the cut of the
  1000 proposals, its level's top-k cut and the proposals over it;
- the box stage follows the program's proposals (recorded where the
  program makes them): the reference pools them from its own features and
  runs its box head.  Each valid detection of the program is matched to
  the reference's (proposal, class) candidate of its class with the
  highest IoU: ``det_box_gap`` is the widest 1 − IoU, ``det_score_misses``
  the share of detections whose score's log-odds lie more than
  SCORE_SLACK from the reference's (log-odds, since a score's rounding
  matters by p·(1 − p); a share, since the gaps' whole spread scales by
  up to 3× with how confident a seed's detections are, so that no mean
  or quantile keeps three times its sound reading under the control's); ``det_nms_violations`` counts the pairs of valid
  detections of one class that overlap by more than the detection NMS
  threshold; ``det_missed_gap``, the widest order flip (in log-odds) of a
  (proposal, class) candidate that the detections leave out, against the
  detections' cut (the last of a full set, else the score threshold), the
  candidates' top-k cut and the detections of its class over it;
- ``mask_gap``: the reference's masks for the program's detections (mask
  head on its features, the mask tail on the program's boxes, classes and
  scores) against the program's packed masks: differing pixels over the
  union, over all checked images (with the configuration's solid masks,
  an exact comparison, which sees a mask head that returns nothing, not
  one that errs inside the masks).

Training (``judge_train``): each of the three check steps' losses (the
widest relative gap over steps and terms), the norm of each leaf's
gradient as the optimizer took it at step 1 (the momentum trace after one
step) and of each leaf's change after three steps, each as the widest gap
of norms over the leaves, against the reference's norm of the leaf or of
the median leaf, whichever is larger; leaves whose reference gradient is
under a thousandth of the median leaf's are left out.  The reference
follows the program's proposals; ``rpn_logit_gap`` and
``rpn_nms_violations`` check step 1's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import maskrcnn as R
from benchmark.reference import masktail
from benchmark.reference.training import Trainer as RefTrainer

PREDICT_NUMBERS = ("rpn_logit_gap", "rpn_nms_violations", "rpn_missed_gap",
                   "det_score_misses", "det_box_gap", "det_nms_violations",
                   "det_missed_gap", "mask_gap")
TRAIN_NUMBERS = ("loss_gap", "grad_gap", "change_gap", "rpn_logit_gap",
                 "rpn_nms_violations")
MATCH_IOU = 0.95
IOU_SLACK = 1e-3
# an overlap this far under an NMS threshold still counts as suppressing
# (the two sides' boxes differ by rounding)
COVER_SLACK = 0.01
# a detection's score misses when its log-odds lie this far from the
# reference's: about twice the widest gap of a detection in sound runs
SCORE_SLACK = 0.25
# scores become log-odds for the comparison, clamped off 0 and 1
ODDS_EPS = 1e-6


def log_odds(p: torch.Tensor) -> torch.Tensor:
    p = p.double().clamp(ODDS_EPS, 1 - ODDS_EPS)
    return torch.log(p / (1 - p))


def violations(boxes, groups, thresh: float) -> int:
    """Pairs of boxes [n,4] of one group (level or class) that overlap by
    more than ``thresh`` + IOU_SLACK."""
    if len(boxes) < 2:
        return 0
    over = (R.iou(boxes, boxes) > thresh + IOU_SLACK) & \
        (groups[:, None] == groups[None])
    return int(torch.triu(over, diagonal=1).sum())


def proposal_numbers(prog: Dict, own: Dict, nms_thresh: float,
                     acc: Dict) -> None:
    """Adds the RPN's readings of one batch to ``acc``: ``prog`` the
    program's proposals {"boxes", "logits", "valid"}, ``own`` the
    reference's (``maskrcnn.proposals``)."""
    for i in range(prog["boxes"].shape[0]):
        pv = prog["valid"][i]
        pb, pl = prog["boxes"][i][pv].float(), prog["logits"][i][pv].float()
        ok = own["cand_logits"][i] > R.NEG / 2
        cb, cl = own["cand_boxes"][i][ok], own["cand_logits"][i][ok]
        lv = own["cand_level"][ok]
        if len(pb) and len(cb):
            ious = R.iou(pb, cb)
            # of the candidates a proposal matches, the one nearest its
            # logit: boxes clipped to the image coincide across levels
            near = torch.where(ious >= MATCH_IOU,
                               (pl[:, None] - cl[None]).abs(),
                               torch.full_like(ious, float("inf")))
            j = near.argmin(-1)
            best = ious.gather(1, j[:, None])[:, 0]
            hit = best >= MATCH_IOU
            gaps = (pl[hit] - cl[j[hit]]).abs()
            acc["rpn_gap_sum"] = acc.get("rpn_gap_sum", 0.0) + float(gaps.sum())
            acc["rpn_matched"] = acc.get("rpn_matched", 0) + int(hit.sum())
            acc["dx_rpn_unmatched"] = acc.get("dx_rpn_unmatched", 0) + \
                int((~hit).sum())
            acc["dx_rpn_iou_min"] = min(acc.get("dx_rpn_iou_min", 1.0),
                                        float(best[hit].min()) if hit.any()
                                        else 1.0)
            acc["dx_rpn_gap_max"] = max(acc.get("dx_rpn_gap_max", 0.0),
                                        float(gaps.max()) if len(gaps) else 0.0)
            acc["rpn_nms_violations"] = acc.get("rpn_nms_violations", 0) + \
                violations(pb[hit], lv[j[hit]], nms_thresh)
    acc.setdefault("rpn_nms_violations", 0)
    acc["rpn_logit_gap"] = acc.get("rpn_gap_sum", 0.0) / max(
        acc.get("rpn_matched", 0), 1)


def missed_gap(cand_boxes, cand_scores, cand_floor, kept_boxes,
               kept_scores, thresh: float, same=None) -> float:
    """The widest order flip of the candidates [N,4] (scores [N], in the
    reference) that no kept box [M,4] matches (IoU >= MATCH_IOU): how far
    one outscores both its floor [N] (the selection's cuts) and every kept
    box (scores [M]) that overlaps it by more than ``thresh`` −
    COVER_SLACK.  ``same`` [N,M]: which kept boxes share a candidate's NMS
    problem (all where None).  0 when every candidate is accounted for."""
    if not len(cand_boxes):
        return 0.0
    low = torch.full_like(cand_scores, -float("inf"))
    if len(kept_boxes):
        ious = R.iou(cand_boxes, kept_boxes)
        if same is not None:
            ious = torch.where(same, ious, torch.zeros_like(ious))
        matched = (ious >= MATCH_IOU).any(1)
        over = torch.where(ious > thresh - COVER_SLACK,
                           kept_scores[None].expand_as(ious),
                           torch.full_like(ious, -float("inf")))
        low = over.amax(1)
    else:
        matched = torch.zeros_like(cand_scores, dtype=torch.bool)
    excess = (cand_scores - torch.maximum(low, cand_floor))[~matched]
    return max(0.0, float(excess.max())) if len(excess) else 0.0


def proposal_coverage(prog: Dict, own: Dict, m: dict, acc: Dict) -> None:
    """``rpn_missed_gap`` of one batch into ``acc``: each image's reference
    candidates (its levels' top-k) against the program's proposals.  A
    candidate's floor: its level's k-th logit where the level was cut,
    and the last proposal's logit where the proposals are a full set;
    where neither, the image's lowest candidate."""
    level = own["cand_level"]
    for i in range(prog["boxes"].shape[0]):
        pv = prog["valid"][i]
        pb, pl = prog["boxes"][i][pv].float(), prog["logits"][i][pv].float()
        ok = own["cand_logits"][i] > R.NEG / 2
        cb, cl = own["cand_boxes"][i][ok], own["cand_logits"][i][ok]
        if not len(cl):
            continue
        floor = torch.full_like(cl, float(cl.min()))
        for lv in torch.unique(level):
            at = level == lv
            if int(at.sum()) >= m["rpn_pre_nms_topk_test"] and (at & ok).any():
                floor[at[ok]] = float(own["cand_logits"][i][at & ok].min())
        if len(pl) >= m["rpn_post_nms_topk_test"]:
            floor = floor.clamp_min(float(pl.min()))
        acc["rpn_missed_gap"] = max(acc.get("rpn_missed_gap", 0.0), missed_gap(
            cb, cl, floor, pb, pl, m["rpn_nms_thresh"]))


def detection_coverage(prop_valid, cand_boxes, cand_scores, boxes, classes,
                       ref_scores, m: dict) -> float:
    """``det_missed_gap`` of one image: the (proposal, class) candidates
    [K,C,4] with the reference's scores [K,C] against the program's valid
    detections (boxes, classes, the reference's scores of their
    candidates), in log-odds.  Floors: the candidates' top-k cut, and the
    last detection of a full set, else the score threshold."""
    k, c = cand_scores.shape
    cb, cs = cand_boxes.reshape(k * c, 4), cand_scores.reshape(k * c)
    cc = torch.arange(c, device=cs.device).repeat(k)
    ok = (cs > m["roi_score_thresh_test"]) & R.nonempty(cb) & \
        prop_valid.repeat_interleave(c)
    cb, cs, cc = cb[ok], log_odds(cs[ok]), cc[ok]
    floor = float(log_odds(torch.tensor(m["roi_score_thresh_test"])))
    if len(cs) > m["nms_candidates_test"]:
        floor = max(floor, float(torch.sort(cs, descending=True).values[
            m["nms_candidates_test"] - 1]))
    kept = log_odds(ref_scores)
    if len(boxes) >= m["detections_per_image"]:
        floor = max(floor, float(kept.min()))
    return missed_gap(cb, cs, torch.full_like(cs, floor), boxes, kept,
                      m["roi_nms_thresh_test"],
                      same=cc[:, None] == classes[None])


# ---------------------------------------------------------------- inference

def prepare_images(raw: List[np.ndarray], inp: dict, device):
    """The configuration's test-time input: each gray [H, W] uint8 image
    resized by its shortest-edge scale (antialiased bilinear), placed at
    the top left of the canvas that the bucket rule gives.  → (images
    [B, Hc, Wc, 3] f32, content (h, w) per image, canvas (Hc, Wc))."""
    sizes, resized = [], []
    for im in raw:
        h, w = im.shape
        scale = inp["test_short_edge"] / min(h, w)
        if max(h, w) * scale > inp["test_max_size"]:
            scale = inp["test_max_size"] / max(h, w)
        ph, pw = inp["pad_size_test"]
        scale = min(scale, ph / h, pw / w)
        oh, ow = min(int(round(h * scale)), ph), min(int(round(w * scale)), pw)
        # resized on the host, as the configuration's front end does
        x = torch.from_numpy(im).float()[None, None]
        if scale < 1.0:
            x = F.interpolate(x, size=(oh, ow), mode="bilinear",
                              align_corners=False, antialias=True)
            x = x.round().clamp(0, 255)
        resized.append(x[0, 0].to(device))
        sizes.append((oh, ow))
    bkt = inp["canvas_bucket"]
    up = lambda v: -(-v // bkt) * bkt
    ch = min(up(max(s[0] for s in sizes)), inp["pad_size_test"][0])
    cw = min(up(max(s[1] for s in sizes)), inp["pad_size_test"][1])
    out = torch.zeros((len(raw), ch, cw, 3), device=device)
    for i, (x, (oh, ow)) in enumerate(zip(resized, sizes)):
        out[i, :oh, :ow] = x[:, :, None]
    return out, sizes, (ch, cw)


def reference_predict(net: R.Net, images, canvas, sizes, cfg: dict,
                      proposals=None) -> Dict:
    """The reference's inference on prepared images: its own proposals,
    the detections over ``proposals`` (the given ones, else its own), and
    its masks of those detections.  → the program's output layout."""
    m = cfg["model"]
    feats = net.features(images, m["pixel_mean"])
    obj, dl = net.rpn(feats)
    anc = R.anchors(canvas, m["anchor_sizes"], m["anchor_aspect_ratios"],
                    images.device)
    own = R.proposals(obj, dl, anc, canvas,
                      R.level_sizes(canvas, len(m["anchor_aspect_ratios"])),
                      m["rpn_pre_nms_topk_test"], m["rpn_post_nms_topk_test"],
                      m["rpn_nms_thresh"])
    use = own if proposals is None else proposals
    pb, pv = use["boxes"], use["valid"]
    b, k = pb.shape[:2]
    pooled = R.pool(feats, pb, m["pooler_resolution_box"], m["pooler_window"])
    logits, deltas = net.box_head(pooled.reshape((b * k,) + pooled.shape[2:]))
    det = R.detections(pb, pv, logits.reshape(b, k, -1),
                       deltas.reshape(b, k, m["num_classes"], 4), canvas,
                       m["roi_score_thresh_test"], m["roi_nms_thresh_test"],
                       m["nms_candidates_test"], m["detections_per_image"],
                       tuple(m["roi_bbox_reg_weights"]))
    return {"features": feats, "own_proposals": own, "det": det}


def mask_stage(net: R.Net, feats, boxes, classes, scores, valid, sizes,
               canvas, cfg: dict):
    """The reference's masks [B,D,Hc,Wc] and keep [B,D] for the given
    detections."""
    m = cfg["model"]
    b, d = boxes.shape[:2]
    pooled = R.pool(feats, boxes, m["pooler_resolution_mask"],
                    m["pooler_window"])
    logits = net.mask_head(pooled.reshape((b * d,) + pooled.shape[2:]))
    res = logits.shape[1]
    logits = logits.reshape(b, d, res, res, -1)
    sel = torch.gather(logits, 4, classes[:, :, None, None, None].expand(
        -1, -1, res, res, 1))[..., 0]
    probs = torch.sigmoid(sel)
    out = [masktail.tail(probs[i], boxes[i], scores[i], valid[i], sizes[i],
                         canvas, cfg["postprocess"]) for i in range(b)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def unpack(packed: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,)) != 0


def judge_predict(net: R.Net, raw: List[np.ndarray], out: Dict, cfg: dict,
                  acc: Dict) -> None:
    """Adds one batch's readings to ``acc``.  ``out``: the program's
    outputs {proposals {"boxes", "logits", "valid"}, boxes, scores,
    classes, det_valid, valid (detections' & keep), masks [B,D,Hc,Wc]
    bool}."""
    dev = out["boxes"].device
    with R.exact_f32(), torch.no_grad():
        images, sizes, canvas = prepare_images(raw, cfg["input"], dev)
        ref = reference_predict(net, images, canvas, sizes, cfg,
                                proposals=out["proposals"])
        proposal_numbers(out["proposals"], ref["own_proposals"],
                         cfg["model"]["rpn_nms_thresh"], acc)
        proposal_coverage(out["proposals"], ref["own_proposals"],
                          cfg["model"], acc)
        acc.setdefault("rpn_missed_gap", 0.0)
        det = ref["det"]
        cb, cs = det["cand_boxes"], det["cand_scores"]     # [B,K,C,4], [B,K,C]
        b = out["boxes"].shape[0]
        for i in range(b):
            v = out["det_valid"][i]
            boxes, cls = out["boxes"][i][v], out["classes"][i][v]
            scores = out["scores"][i][v]
            if len(boxes):
                cand = cb[i].permute(1, 0, 2)[cls]               # [n,K,4]
                ious = R.iou(boxes[:, None, :], cand)[:, 0]      # [n,K]
                best, j = ious.max(-1)
                ref_s = cs[i].permute(1, 0)[cls].gather(1, j[:, None])[:, 0]
                acc["det_box_gap"] = max(acc.get("det_box_gap", 0.0),
                                         float((1 - best).max()))
                acc.setdefault("det_gaps", []).append(
                    (log_odds(scores) - log_odds(ref_s)).abs().cpu())
                acc["dx_det_score_gap_max"] = max(
                    acc.get("dx_det_score_gap_max", 0.0),
                    float((scores - ref_s).abs().max()))
            else:
                ref_s = scores
            acc["det_missed_gap"] = max(
                acc.get("det_missed_gap", 0.0), detection_coverage(
                    out["proposals"]["valid"][i], cb[i], cs[i], boxes, cls,
                    ref_s, cfg["model"]))
            acc["det_nms_violations"] = acc.get("det_nms_violations", 0) + \
                violations(boxes, cls, cfg["model"]["roi_nms_thresh_test"])
        acc.setdefault("det_box_gap", 0.0)
        gaps = torch.cat(acc.get("det_gaps", []) or [torch.zeros(1)])
        acc["det_score_misses"] = float((gaps > SCORE_SLACK).double().mean())
        acc["dx_det_lo_gap_median"] = float(gaps.median())
        acc["dx_det_lo_gap_mean"] = float(gaps.mean())
        acc["dx_det_lo_gap_p90"] = float(gaps.quantile(0.9))
        acc["dx_det_lo_gap_max"] = float(gaps.max())
        masks, keep = mask_stage(net, ref["features"], out["boxes"],
                                 out["classes"], out["scores"],
                                 out["det_valid"], sizes, canvas, cfg)
        mine = masks & (keep & out["det_valid"])[..., None, None]
        theirs = out["masks"] & out["valid"][..., None, None]
        acc["xor"] = acc.get("xor", 0) + int((mine ^ theirs).sum())
        acc["union"] = acc.get("union", 0) + int((mine | theirs).sum())
        acc["mask_gap"] = acc["xor"] / max(acc["union"], 1)
        acc.setdefault("detections", 0)
        acc["detections"] += int(out["valid"].sum())
        acc.setdefault("proposals", 0)
        acc["proposals"] += int(out["proposals"]["valid"].sum())
        acc.setdefault("mask_px", 0)
        acc["mask_px"] += int(theirs.sum())


def log_diagnostics(acc: Dict) -> None:
    import sys

    out = {k: v for k, v in acc.items() if k.startswith("dx_")}
    print("diagnostics " + str(out), file=sys.stderr, flush=True)


def program_like(net: R.Net, raw, cfg: dict, device) -> Dict:
    """A reference (e.g. in a lower precision) run in the program's place:
    its outputs in the layout ``judge_predict`` reads."""
    with R.exact_f32(), torch.no_grad():
        images, sizes, canvas = prepare_images(raw, cfg["input"], device)
        ref = reference_predict(net, images, canvas, sizes, cfg)
        det = ref["det"]
        masks, keep = mask_stage(net, ref["features"], det["boxes"],
                                 det["classes"], det["scores"], det["valid"],
                                 sizes, canvas, cfg)
        valid = det["valid"] & keep
        return {"proposals": ref["own_proposals"], "boxes": det["boxes"],
                "scores": det["scores"], "classes": det["classes"],
                "det_valid": det["valid"], "valid": valid,
                "masks": masks & valid[..., None, None]}


# ---------------------------------------------------------------- training

def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: List[str]) -> float:
    """Widest |‖prog‖ − ‖ref‖| over ``leaves``, against the larger of the
    reference's norm of the leaf and of the median leaf."""
    pn = {k: float(prog[k].double().norm()) for k in leaves}
    rn = {k: float(ref[k].double().norm()) for k in leaves}
    med = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in leaves)


def judge_train(weights, batches, cfg: dict, seed: int, prog: Dict,
                block: int = 4) -> Dict[str, float]:
    """``prog``: {"losses": [3 × {term: float}], "grad1": {path: tensor},
    "change": {path: tensor}, "proposals": [3 × (boxes, scores, valid)]}
    → the numbers."""
    if any(p["boxes"].shape[0] != b["image"].shape[0]
           for p, b in zip(prog["proposals"], batches)):
        # the program's RPN did not see the whole batch
        return dict.fromkeys(TRAIN_NUMBERS, float("inf")) | {
            "leaves": 0, "leaves_left_out": 0, "term_gaps": {},
            "ref_losses": []}
    with R.exact_f32():
        ref = RefTrainer(weights, cfg, block=block)
        with torch.no_grad():
            own = ref.own_proposals(batches[0], seed)
        losses, grad1 = [], None
        for step, batch in enumerate(batches):
            got, _ = ref.run_step(batch, seed,
                                  proposals=prog["proposals"][step])
            losses.append(got)
            if step == 0:
                grad1 = {k: t.clone() for k, t in ref.traces.items()}
        change = {k: ref.params[k].detach() - weights[k].float()
                  for k in ref.train_keys}
    norms = {k: float(grad1[k].double().norm()) for k in ref.train_keys}
    med = float(np.median(list(norms.values())))
    leaves = [k for k in ref.train_keys if norms[k] >= 1e-3 * med]
    gaps = {t: max(abs(p[t] - r[t]) / max(abs(r[t]), 1e-12)
                   for p, r in zip(prog["losses"], losses)) for t in losses[0]}
    loss_gap = max(gaps.values())
    rpn: Dict = {}
    proposal_numbers(prog["proposals"][0], own, cfg["model"]["rpn_nms_thresh"],
                     rpn)
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog["grad1"], grad1, leaves),
            "change_gap": leaf_gap(prog["change"], change, leaves),
            "rpn_logit_gap": rpn["rpn_logit_gap"],
            "rpn_nms_violations": rpn["rpn_nms_violations"],
            "leaves": len(leaves), "leaves_left_out": len(ref.train_keys)
            - len(leaves), "term_gaps": gaps,
            "ref_losses": losses}


def control_train(weights, batches, cfg: dict, seed: int, quant: str,
                  block: int = 4) -> Dict:
    """The reference computed in ``quant`` in the program's place: its
    losses, step-1 optimizer gradient, change and proposals."""
    with R.exact_f32():
        ctl = RefTrainer(weights, cfg, quant=quant, block=block)
        losses, props, grad1 = [], [], None
        for step, batch in enumerate(batches):
            got, used = ctl.run_step(batch, seed)
            losses.append(got)
            props.append(used)
            if step == 0:
                grad1 = {k: t.clone() for k, t in ctl.traces.items()}
        change = {k: ctl.params[k].detach() - weights[k].float()
                  for k in ctl.train_keys}
    return {"losses": losses, "grad1": grad1, "change": change,
            "proposals": props}
