"""Submit a training script of the port to SLURM.

The port's own copy of ``torch_em_tpu/utils/submit_slurm.py`` (after
torch-em's ``util/submit_slurm.py``): ``write_slurm_template`` writes a batch
script that asks for one GPU and runs the script with the Python interpreter
that submits it (or, with ``env_name``, ``python`` after ``source activate
env_name``); ``submit_slurm`` writes it into ``tmp_folder`` and calls
``sbatch``. ``main`` is the command line: ``python -m
torch_em_tpu_torch.utils.submit_slurm script.py [--n_threads 8 ...] [script
arguments]``.
"""

import os
import subprocess
import sys
from datetime import datetime

__all__ = ["write_slurm_template", "submit_slurm", "main"]


def write_slurm_template(script, out_path, env_name, n_threads, mem_limit, time_limit, qos, mail_address=None,
                         exclude_nodes=None):
    """Write the batch script: one node, one GPU, ``n_threads`` cores, then ``script`` with the
    job's arguments."""
    lines = ["#!/bin/bash", "#SBATCH -N 1", f"#SBATCH -c {n_threads}", f"#SBATCH --mem {mem_limit}",
             f"#SBATCH -t {time_limit}", f"#SBATCH --qos={qos}", "#SBATCH --gres=gpu:1"]
    if mail_address is not None:
        lines += ["#SBATCH --mail-type=FAIL,BEGIN,END", f"#SBATCH --mail-user={mail_address}"]
    if exclude_nodes is not None:
        lines.append(f"#SBATCH --exclude={','.join(exclude_nodes)}")
    python = "python" if env_name is not None else sys.executable
    lines += [""] + ([f"source activate {env_name}", ""] if env_name is not None else []) + [f"{python} {script} $@"]
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")


def submit_slurm(script, input_, n_threads=7, mem_limit="64G", time_limit="2-00:00:00", qos="normal",
                 env_name=None, mail_address=None, exclude_nodes=None, tmp_folder=None):
    """Write the batch script for ``script`` and its arguments ``input_`` and submit it with
    ``sbatch``; the script, its log and its error file go to ``tmp_folder``
    (``~/.tpu_em_torch/slurm`` by default)."""
    tmp_folder = os.path.expanduser("~/.tpu_em_torch/slurm") if tmp_folder is None else tmp_folder
    os.makedirs(tmp_folder, exist_ok=True)
    print(f"Submitting training script {script} to cluster")
    print(f"with arguments {' '.join(input_)}")

    script_name = os.path.splitext(os.path.split(script)[1])[0]
    tmp_name = f"{script_name}_{datetime.now().strftime('%Y_%m_%d_%H_%M_%S_%f')}"
    batch_script = os.path.join(tmp_folder, f"{tmp_name}.sh")
    log = os.path.join(tmp_folder, f"{tmp_name}.log")
    err = os.path.join(tmp_folder, f"{tmp_name}.err")
    write_slurm_template(script, batch_script, env_name, int(n_threads), mem_limit, time_limit, qos,
                         mail_address, exclude_nodes)
    cmd = ["sbatch", "-o", log, "-e", err, "-J", script_name, batch_script] + list(input_)
    subprocess.run(cmd, check=True)
    return batch_script


def inspect_signature():
    """The names of ``submit_slurm``'s options (all but the script and its arguments)."""
    import inspect

    return list(inspect.signature(submit_slurm).parameters)[2:]


def scrape_kwargs(input_):
    """Split the command line into ``submit_slurm``'s options and the script's arguments."""
    params = inspect_signature()
    kwargs, remaining = {}, []
    i = 0
    while i < len(input_):
        arg = input_[i]
        name = arg.lstrip("-")
        if arg.startswith("-") and name in params:
            kwargs[name] = input_[i + 1]
            i += 2
        else:
            remaining.append(arg)
            i += 1
    return kwargs, remaining


def main():
    script = os.path.realpath(os.path.abspath(sys.argv[1]))
    kwargs, input_ = scrape_kwargs(sys.argv[2:])
    submit_slurm(script, input_, **kwargs)


if __name__ == "__main__":
    main()
