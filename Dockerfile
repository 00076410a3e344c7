# Container image for platypus-tpu (CPU by default; install jax[cuda12] in
# place of jax[cpu] for a GPU host).  Counterpart of the reference's
# ubuntu-14.04 + htslib Dockerfile.
FROM python:3.12-slim

RUN apt-get update \
    && apt-get install -y --no-install-recommends g++ make zlib1g-dev \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/platypus-tpu
COPY . .

RUN pip install --no-cache-dir "jax[cpu]" numpy pytest \
    && make native \
    && pip install --no-cache-dir .

ENTRYPOINT ["platypus-tpu"]
CMD ["callVariants", "--help"]
