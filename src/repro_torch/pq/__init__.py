from repro_torch.pq.pq import (PQCodebook, train_pq, encode_pq, adc_lut,
                               adc_lut_batch, adc_distance, reconstruct)
