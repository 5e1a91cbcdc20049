from parca_agent_tpu_torch.cli import run

if __name__ == "__main__":
    raise SystemExit(run(hard_exit=True))
