"""repro_torch.configs: the LM configurations (dense Llama 3.x, SmolLM and
Mistral; Llama 4 Scout and Maverick, MoE with chunked-local attention) and
the recsys ones (FM, SASRec, AutoInt, DLRM-MLPerf)."""
