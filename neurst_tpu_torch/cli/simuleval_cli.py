"""Simultaneous-translation evaluation (the port's counterpart of
``neurst_tpu/cli/simuleval_cli.py``).

Offline mode streams each line of ``--src_file`` token by token through
the wait-k agent and reports latency (AL, Average Lagging; CW, the mean
run of consecutive reads between writes) and, with ``--ref_file``, the
task's metric (BLEU); ``--output_file`` gets the hypotheses.  Online mode
(``--hostname``) is scored by a SimulEval v1 server: READ pulls source
units from it, WRITE sends target words (subword units merged at ``@@``),
and the source's EOS goes to the agent when the server's units run out.
``--device`` picks the card as ``run_exp`` does: the current CUDA device
by default; without CUDA it raises unless ``--device cpu`` is given.

Usage:
    python -m neurst_tpu_torch.cli.simuleval_cli --model_dir waitk_ckpt \\
        --src_file test.src --ref_file test.ref [--wait_k 3] [--device cpu]
"""

import argparse
import logging

import numpy as np

import neurst_tpu_torch  # noqa: F401 - fills the registries
from neurst_tpu_torch.exps.base_experiment import BaseExperiment
from neurst_tpu_torch.models.model import resolve_device
from neurst_tpu_torch.tasks.task import build_task
from neurst_tpu_torch.utils.configurable import (
    ModelConfigs, strip_training_only_model_flags)
from neurst_tpu_torch.utils.simuleval_agents.online_client import (
    DEFAULT_EOS, SimulEvalClient)
from neurst_tpu_torch.utils.simuleval_agents.simul_trans_text_agent import (
    SimulTransTextAgent, average_lagging)

__all__ = ["main", "run_online", "consecutive_wait"]


def consecutive_wait(delays) -> float:
    """The mean run of consecutive reads between writes."""
    runs, prev = [], 0
    for d in delays:
        runs.append(d - prev)
        prev = d
    return float(np.mean([r for r in runs if r > 0] or [0]))


def run_online(agent, task, hostname, port):
    """Evaluates ``agent`` against a SimulEval v1 server: returns (and
    prints) the server's scores."""
    client = SimulEvalClient(hostname, port)
    n = int(client.corpus_info()["num_sentences"])
    src_pipeline, trg_pipeline = task.src_pipeline, task.trg_pipeline
    trg_meta = trg_pipeline.meta
    src_eos = src_pipeline.meta["eos_id"]
    for i in range(n):
        state = {"exhausted": False, "pending": []}

        def read_fn(instance=i, state=state):
            if state["exhausted"]:
                return None
            seg = client.get_source(instance)["segment"]
            if seg in (DEFAULT_EOS, ""):
                # the encoder sees the sentence-final EOS, as in training
                state["exhausted"] = True
                return [src_eos]
            # a unit arrives alone: drop the EOS the pipeline appends
            return src_pipeline.encode(seg)[:-1]

        def flush(instance=i, state=state):
            if state["pending"]:
                client.send_hypo(instance, trg_pipeline.decode(
                    state["pending"] + [trg_meta["eos_id"]]))
                state["pending"] = []

        def on_write(token_id, instance=i, state=state):
            """Buffers a unit whose token continues a word ('@@')."""
            state["pending"].append(int(token_id))
            token = trg_pipeline.vocab.map_id_to_token(int(token_id))
            if not (isinstance(token, str) and token.endswith("@@")):
                flush(instance, state)

        agent.translate_stream(read_fn, eos_id=trg_meta["eos_id"],
                               bos_id=trg_meta.get("bos_id"),
                               on_write=on_write)
        flush()
        client.send_hypo(i, DEFAULT_EOS)
    scores = client.get_scores()
    logging.info("SimulEval server scores: %s", scores)
    print(scores)
    return scores


def build_agent(model_dir, wait_k=None, max_decode_len=200, device=None):
    """(agent, task) of ``model_dir``'s newest checkpoint on ``device``."""
    cfg = ModelConfigs.load(model_dir)
    cfg["model.params"] = strip_training_only_model_flags(
        cfg.get("model.params"))
    task = build_task(cfg)
    model = task.build_model(cfg, device=resolve_device(device))
    BaseExperiment(model=model, model_dir=model_dir).restore_params()
    return SimulTransTextAgent(model, k=wait_k,
                               max_decode_len=max_decode_len), task


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Simultaneous MT evaluation.")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--src_file", default=None,
                   help="Offline mode: source sentences (built-in "
                        "simulator).")
    p.add_argument("--hostname", default=None,
                   help="Online mode: SimulEval server hostname.")
    p.add_argument("--port", type=int, default=12321,
                   help="Online mode: SimulEval server port.")
    p.add_argument("--ref_file", default=None)
    p.add_argument("--wait_k", type=int, default=None,
                   help="Override the decode-time lagging.")
    p.add_argument("--max_decode_len", type=int, default=200)
    p.add_argument("--output_file", default=None)
    p.add_argument("--device", default=None,
                   help="The torch device ('cpu' runs the plain versions "
                        "of the kernels); the current CUDA device by "
                        "default.")
    args = p.parse_args(argv)
    if not (args.hostname or args.src_file):
        p.error("either --src_file (offline) or --hostname (online) "
                "is required")
    agent, task = build_agent(args.model_dir, args.wait_k,
                              args.max_decode_len, args.device)
    if args.hostname:
        return run_online(agent, task, args.hostname, args.port)

    src_pipeline, trg_pipeline = task.src_pipeline, task.trg_pipeline
    trg_meta = trg_pipeline.meta
    hypotheses, lags, cws = [], [], []
    with open(args.src_file, encoding="utf-8") as f:
        sources = [line.strip() for line in f]
    for i, src in enumerate(sources):
        src_ids = src_pipeline.encode(src)
        out_ids, delays = agent.translate(
            src_ids, eos_id=trg_meta["eos_id"],
            bos_id=trg_meta.get("bos_id"))
        hypotheses.append(trg_pipeline.decode(out_ids + [trg_meta["eos_id"]]))
        lags.append(average_lagging(delays, len(src_ids), len(out_ids)))
        cws.append(consecutive_wait(delays))
        if i < 3:
            logging.info("sample %d | AL=%.2f | hyp: %s", i, lags[-1],
                         hypotheses[-1][:100])
    results = {"AL": float(np.mean(lags)), "CW": float(np.mean(cws)),
               "samples": len(hypotheses)}
    if args.ref_file:
        with open(args.ref_file, encoding="utf-8") as f:
            refs = [line.strip() for line in f][:len(hypotheses)]
        results.update(task.get_eval_metric({})(hypotheses, refs))
    if args.output_file:
        with open(args.output_file, "w", encoding="utf-8") as f:
            for h in hypotheses:
                f.write(h + "\n")
    print(results)
    return results


if __name__ == "__main__":
    main()
